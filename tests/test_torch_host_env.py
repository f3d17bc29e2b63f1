"""Port vs JAX: the host envs (lightzero_tpu_torch/envs/{host_env,dmc2gym_env,
atari,minigrid_env,jericho_env,metadrive_env,pooltool_env}.py against their
lightzero_tpu/envs counterparts) and the host-env dispatch
(entry/train_muzero.py:make_host_vec_env).

- HostVecEnv on CartPole-v1, MountainCar-v0, LunarLander-v3 and
  LunarLanderContinuous-v3, short time limits so that every env resets
  several times: the same seed and actions (continuous ones beyond [-1, 1],
  so that the clip shows) give bit-equal observations, rewards, dones, legal
  masks and players, and the continuous actions reach gymnasium bit-equal
  (the map from [-1, 1] onto the box).
- A dm_control state rollout (cartpole swingup, a frame skip that ends an
  episode every 10 steps) is bit-equal to JAX's on the same seed.
- _resize_bilinear and hash_tokenize equal JAX's exactly.
- make_host_vec_env routes every family as JAX's does: the same adapter
  class, the same gated ImportError for the libraries absent here; the
  zoo's "lunarlander" id, on which gymnasium fails in JAX, is refused.
- Every gated adapter raises ImportError with "gated adapter" where its
  library is absent, and is_available() agrees with JAX's.
No DMC pixels are rendered here (tests/test_torch_host_configs.py renders
them in a process of their own).
"""
import importlib

import numpy as np
import pytest

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.entry.train_muzero import make_host_vec_env as jax_make_host_vec_env
from lightzero_tpu.envs.host_env import HostVecEnv as JaxHostVecEnv
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry.train_muzero import JAX_HOST_ENV_FAULTS, make_host_vec_env
from lightzero_tpu_torch.envs.host_env import HostVecEnv

pytestmark = pytest.mark.unittest

NUM_ENVS = 3
GYM_ENVS = [("CartPole-v1", 9), ("MountainCar-v0", 7), ("LunarLander-v3", 11),
            ("LunarLanderContinuous-v3", 11)]


def _actions(env, rng, steps):
    if env.continuous:
        return rng.uniform(-1.5, 1.5, (steps, env.num_envs, env.action_space_size)).astype(
            np.float32)
    return rng.integers(0, env.action_space_size, (steps, env.num_envs))


def _record_actions(env):
    """Wrap each gymnasium env's step to record the action it receives."""
    seen = []
    for e in env._envs:
        step = e.step

        def recording(a, step=step):
            seen.append(np.array(a, copy=True))
            return step(a)

        e.step = recording
    return seen


@pytest.mark.parametrize("env_id,limit", GYM_ENVS, ids=[e for e, _ in GYM_ENVS])
def test_host_vec_env_matches_jax(env_id, limit):
    kwargs = dict(max_episode_steps=limit)
    jax_env = JaxHostVecEnv(env_id, NUM_ENVS, seed=5, env_kwargs=kwargs)
    env = HostVecEnv(env_id, NUM_ENVS, seed=5, env_kwargs=kwargs)
    for attr in ("action_space_size", "continuous", "observation_shape", "num_envs"):
        assert getattr(env, attr) == getattr(jax_env, attr), attr
    jax_seen, seen = _record_actions(jax_env), _record_actions(env)
    for exp, got in zip(jax_env.reset_all(), env.reset_all()):
        np.testing.assert_array_equal(got, exp)
        assert got.dtype == exp.dtype
    steps = 3 * limit + 2
    dones = 0
    for a in _actions(env, np.random.default_rng(0), steps):
        exp, got = jax_env.step(a), env.step(a)
        for name, e, g in zip(("obs", "reward", "done", "legal", "to_play"), exp, got):
            np.testing.assert_array_equal(g, e, err_msg=name)
            assert g.dtype == e.dtype, name
        dones += int(got[2].sum())
    assert dones >= 2 * NUM_ENVS  # every env reset more than once
    assert env._seeds == jax_env._seeds  # seed + i, then +10,000 per reset
    assert len(seen) == len(jax_seen) == steps * NUM_ENVS
    for g, e in zip(seen, jax_seen):
        np.testing.assert_array_equal(g, e)
        assert type(g) is type(e) and g.dtype == e.dtype
    if env.continuous:
        assert all(np.all(np.abs(a) <= 1.0) for a in seen)  # Box(-1, 1): the clip shows


def test_dm_control_state_rollout_matches_jax():
    from lightzero_tpu.envs.dmc2gym_env import DMC2GymVecEnv as JaxDMC
    from lightzero_tpu_torch.envs.dmc2gym_env import DMC2GymVecEnv

    # 1000 control steps an episode: a frame skip of 100 ends one every 10 steps
    jax_env = JaxDMC("cartpole", "swingup", num_envs=2, seed=3, frame_skip=100)
    env = DMC2GymVecEnv("cartpole", "swingup", num_envs=2, seed=3, frame_skip=100)
    assert env.observation_shape == jax_env.observation_shape == 5
    assert env.action_space_size == jax_env.action_space_size == 1
    for exp, got in zip(jax_env.reset_all(), env.reset_all()):
        np.testing.assert_array_equal(got, exp)
    rng = np.random.default_rng(1)
    dones = 0
    for _ in range(23):
        a = rng.uniform(-1.5, 1.5, (2, 1)).astype(np.float32)
        exp, got = jax_env.step(a), env.step(a)
        for name, e, g in zip(("obs", "reward", "done", "legal", "to_play"), exp, got):
            np.testing.assert_array_equal(g, e, err_msg=name)
            assert g.dtype == e.dtype, name
        dones += int(got[2].sum())
    assert dones == 4


def test_resize_bilinear_matches_jax():
    from lightzero_tpu.envs.atari import _resize_bilinear as jax_resize
    from lightzero_tpu_torch.envs.atari import _resize_bilinear

    rng = np.random.default_rng(0)
    for shape, out in [((210, 160, 3), (96, 96)), ((8, 8, 1), (8, 8)), ((5, 7, 2), (11, 3))]:
        img = rng.integers(0, 256, shape).astype(np.uint8)
        got, exp = _resize_bilinear(img, *out), jax_resize(img, *out)
        np.testing.assert_array_equal(got, exp)
        assert got.dtype == exp.dtype and got.shape == out + shape[2:]


def test_hash_tokenize_matches_jax():
    from lightzero_tpu.envs.jericho_env import hash_tokenize as jax_tokenize
    from lightzero_tpu_torch.envs.jericho_env import hash_tokenize

    for text, n in [("open the mailbox", 8), ("West of House  You are standing", 4), ("", 3),
                    ("a b c d e f g h i j", 16)]:
        for got, exp in zip(hash_tokenize(text, n), jax_tokenize(text, n)):
            np.testing.assert_array_equal(got, exp)
            assert got.dtype == exp.dtype
    ids, mask = hash_tokenize("open the mailbox", 8, vocab_size=11)
    assert mask.sum() == 3 and (ids[:3] >= 2).all() and (ids[:3] < 11).all()


GATED = [
    ("minigrid_env", "MiniGridVecEnv", {}),
    ("jericho_env", "JerichoVecEnv", {"game_path": "x.z5"}),
    ("metadrive_env", "MetaDriveVecEnv", {}),
    ("pooltool_env", "SumToThreeVecEnv", {}),
    ("atari", "AtariEnv", {}),
]


@pytest.mark.parametrize("module,cls,kwargs", GATED, ids=[g[0] for g in GATED])
def test_gated_adapter_raises_import_error_where_its_library_is_absent(module, cls, kwargs):
    port = importlib.import_module(f"lightzero_tpu_torch.envs.{module}")
    jax_mod = importlib.import_module(f"lightzero_tpu.envs.{module}")
    assert port.is_available() == jax_mod.is_available() is False
    with pytest.raises(ImportError, match="gated adapter"):
        getattr(port, cls)(**kwargs)
    # the JAX adapter fails too (its Atari env with gymnasium's own error)
    with pytest.raises(ImportError if module != "atari" else Exception):
        getattr(jax_mod, cls)(**kwargs)


# env id -> (the adapter both packages build, or the error where its library
# is absent here)
FAMILIES = [
    ("ALE/Pong-v5", ImportError),
    ("MiniGrid-Empty-8x8-v0", ImportError),
    ("minigrid", ImportError),
    ("jericho", ImportError),
    ("metadrive", ImportError),
    ("sum_to_three", ImportError),
    ("pooltool", ImportError),
    ("dmc2gym", "DMC2GymVecEnv"),
    ("MountainCar-v0", "HostVecEnv"),
    ("Hopper-v4", "HostVecEnv"),
    ("BipedalWalker-v3", "HostVecEnv"),
]


@pytest.mark.parametrize("env_id,expected", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_make_host_vec_env_routes_each_family_as_jax(env_id, expected):
    kwargs = {"game_path": "x.z5"} if env_id == "jericho" else {}
    cfg = dict(env_id=env_id, env_kwargs=kwargs)
    if expected is ImportError:
        with pytest.raises(ImportError, match="gated adapter"):
            make_host_vec_env(Config(cfg), 2, 0)
        with pytest.raises(Exception):  # ImportError, or gymnasium's error for ALE ids
            jax_make_host_vec_env(JaxConfig(cfg), 2, 0)
        return
    env = make_host_vec_env(Config(cfg), 2, 7)
    jax_env = jax_make_host_vec_env(JaxConfig(cfg), 2, 7)
    assert type(env).__name__ == type(jax_env).__name__ == expected
    for attr in ("num_envs", "action_space_size", "continuous", "observation_shape"):
        assert getattr(env, attr) == getattr(jax_env, attr), attr
    for got, exp in zip(env.reset_all(), jax_env.reset_all()):
        np.testing.assert_array_equal(got, exp)


def test_the_lunarlander_id_fails_in_jax_and_is_refused():
    import gymnasium

    cfg = dict(type="lunarlander")
    with pytest.raises(gymnasium.error.NameNotFound, match="lunarlander"):
        jax_make_host_vec_env(JaxConfig(cfg), 1, 0)
    with pytest.raises(ValueError, match="NameNotFound"):
        make_host_vec_env(Config(cfg), 1, 0)
    assert set(JAX_HOST_ENV_FAULTS) == {"lunarlander"}
