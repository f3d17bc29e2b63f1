"""Port vs JAX: the bsuite probes, the memory env and the env wrappers
(lightzero_tpu_torch/envs/{bsuite_like,memory_env,wrappers}.py against
lightzero_tpu/envs/{bsuite_like,memory_env,wrappers}.py), then their five
configs through the port's entry.

- DeepSea, Catch and Memory run 8 envs side by side in both packages for
  numpy-seeded random actions over several episodes (auto-reset included).
  The JAX env draws a fresh episode from its step key (Catch's ball column,
  Memory's cue); the test makes the same draw from the same key and hands it
  to the port's ``transition``. Observations, rewards, done flags, legal
  masks and to-play agree exactly at every step (sums of exact floats, and
  t / T, a product by the float32 reciprocal on both sides). The JAX
  DeepSea's ``randomize_actions`` changes nothing.
- ``PadVectorObs`` over DeepSea agrees exactly; ``DiscretizeAction`` over
  Pendulum (2 and 7 bins, no episode end in 30 steps) agrees to 1e-5: its
  levels are ``torch.linspace``'s, within 1.2e-7 of ``jnp.linspace``'s.
- The five configs equal the zoo files key for key and run shrunk through
  ``train_muzero`` on the CPU (4 simulations, batch 8, latent 16).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.envs.bsuite_like import CatchEnv as JaxCatch
from lightzero_tpu.envs.bsuite_like import DeepSeaEnv as JaxDeepSea
from lightzero_tpu.envs.memory_env import MemoryEnv as JaxMemory
from lightzero_tpu.envs.pendulum import PendulumEnv as JaxPendulum
from lightzero_tpu.envs.wrappers import DiscretizeAction as JaxDiscretize
from lightzero_tpu.envs.wrappers import PadVectorObs as JaxPad
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import train_muzero
from lightzero_tpu_torch.entry.train_muzero import create_env
from lightzero_tpu_torch.envs import (
    CatchEnv,
    DeepSeaEnv,
    DiscretizeAction,
    MemoryEnv,
    PadVectorObs,
    PendulumEnv,
)
from lightzero_tpu_torch.envs.bsuite_like import CatchState, DeepSeaState
from lightzero_tpu_torch.envs.memory_env import MemoryState
from lightzero_tpu_torch.envs.pendulum import PendulumState

pytestmark = pytest.mark.unittest

B = 8
LEVEL_TOL = 1.2e-7
PENDULUM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once: their thread pools would
    fight over the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x).copy())
    return t if dtype is None else t.to(dtype)


def _state(cls, jstate):
    return cls(*(_t(x) for x in jstate))


def _assert_step(step, jstep, atol=0.0):
    np.testing.assert_allclose(step.obs.numpy(), np.asarray(jstep.obs), rtol=0, atol=atol)
    np.testing.assert_allclose(step.reward.numpy(), np.asarray(jstep.reward), rtol=0, atol=atol)
    np.testing.assert_array_equal(step.done.numpy(), np.asarray(jstep.done))
    np.testing.assert_array_equal(step.legal_mask.numpy(), np.asarray(jstep.legal_mask))
    np.testing.assert_array_equal(step.to_play.numpy(), np.asarray(jstep.to_play))
    assert not step.truncated.any()


def _run(jenv, env, state_cls, steps, seed, draw=None, port_step=None, actions=None):
    """Both envs side by side; ``draw(key)`` is the fresh-episode draw the
    JAX env makes from a step key, handed to ``port_step``. Returns the
    number of episode ends."""
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    state = _state(state_cls, jstate)
    np.testing.assert_array_equal(env.observe(state).numpy(), np.asarray(jobs))
    jstep_fn = jax.jit(jax.vmap(jenv.step))
    ends = 0
    for t in range(steps):
        a = rng.integers(0, env.action_space_size, B) if actions is None else actions(rng)
        keys = jax.random.split(jax.random.PRNGKey(1000 * seed + t), B)
        jstep = jstep_fn(jstate, jnp.asarray(a, jnp.int32), keys)
        if port_step is None:
            step = env.step(state, _t(a), torch.Generator())
        else:
            step = port_step(state, _t(a), _t(jax.vmap(draw)(keys), torch.int32))
        _assert_step(step, jstep)
        jstate, state = jstep.state, step.state
        for x, y in zip(state, jstate):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        ends += int(step.done.sum())
    return ends


@pytest.mark.parametrize("size", [4, 10])
def test_deep_sea_matches_jax(size):
    # mostly right, so that some trajectories reach the treasure
    ends = _run(JaxDeepSea(size), DeepSeaEnv(size), DeepSeaState, 6 * size, seed=size,
                actions=lambda rng: (rng.random(B) < 0.8).astype(np.int64))
    assert ends >= 5 * B
    # the JAX env accepts randomize_actions and ignores it (ROADMAP queue 3)
    _run(JaxDeepSea(size, randomize_actions=True), DeepSeaEnv(size),
         DeepSeaState, 2 * size, seed=size,
         actions=lambda rng: (rng.random(B) < 0.8).astype(np.int64))


@pytest.mark.parametrize("rows,cols", [(10, 5), (6, 3)])
def test_catch_matches_jax_under_its_draws(rows, cols):
    jenv, env = JaxCatch(rows, cols), CatchEnv(rows, cols)
    ends = _run(jenv, env, CatchState, 4 * rows, seed=rows,
                draw=lambda k: jax.random.randint(k, (), 0, cols), port_step=env.transition)
    assert ends >= 3 * B


@pytest.mark.parametrize("num_cues,memory_length", [(4, 10), (3, 2)])
def test_memory_matches_jax_under_its_draws(num_cues, memory_length):
    jenv, env = JaxMemory(num_cues, memory_length), MemoryEnv(num_cues, memory_length)
    ends = _run(jenv, env, MemoryState, 3 * (memory_length + 2) + 1, seed=num_cues,
                draw=lambda k: jax.random.randint(k, (), 0, num_cues), port_step=env.transition)
    assert ends == 3 * B


def test_envs_reset_themselves_and_draw_from_the_generator():
    for env in (CatchEnv(), MemoryEnv(), DeepSeaEnv()):
        g = torch.Generator().manual_seed(0)
        state, obs = env.reset(64, g)
        assert obs.shape == (64, env.observation_shape)
        assert env.initial_to_play(state).tolist() == [-1] * 64
        for _ in range(12):
            step = env.step(state, torch.randint(0, env.action_space_size, (64,), generator=g), g)
            state = step.state
        assert step.obs.shape == (64, env.observation_shape)
    cols = CatchEnv().draw_reset(4096, torch.Generator().manual_seed(1))
    assert set(cols.tolist()) == set(range(5))


def test_pad_vector_obs_matches_jax():
    jenv, env = JaxPad(JaxDeepSea(4), 20), PadVectorObs(DeepSeaEnv(4), 20)
    assert env.observation_shape == 20 and env.action_space_size == 2
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    state, obs = env.reset(B, torch.Generator())
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    rng = np.random.default_rng(0)
    for t in range(12):
        a = rng.integers(0, 2, B)
        jstep = jax.vmap(jenv.step)(jstate, jnp.asarray(a, jnp.int32), keys)
        step = env.step(state, _t(a), torch.Generator())
        _assert_step(step, jstep)
        jstate, state = jstep.state, step.state
    with pytest.raises(ValueError):
        PadVectorObs(DeepSeaEnv(5), 20)


@pytest.mark.parametrize("bins", [2, 7])
def test_discretize_action_matches_jax(bins):
    jenv, env = JaxDiscretize(JaxPendulum(), bins), DiscretizeAction(PendulumEnv(), bins)
    assert env.action_space_size == jenv.action_space_size == bins
    a = np.arange(bins)
    levels = np.stack([np.asarray(jenv._to_continuous(jnp.int32(i))) for i in a])
    np.testing.assert_allclose(env.to_continuous(_t(a)).numpy().reshape(levels.shape), levels,
                               rtol=0, atol=LEVEL_TOL)
    keys = jax.random.split(jax.random.PRNGKey(bins), B)
    jstate, _ = jax.vmap(jenv.reset)(keys)
    state = _state(PendulumState, jstate)
    rng = np.random.default_rng(bins)
    for t in range(30):
        a = rng.integers(0, bins, B)
        jstep = jax.vmap(jenv.step)(jstate, jnp.asarray(a, jnp.int32), keys)
        step = env.step(state, _t(a), torch.Generator())
        _assert_step(step, jstep, atol=PENDULUM_TOL)
        jstate, state = jstep.state, step.state
    with pytest.raises(ValueError):
        DiscretizeAction(DeepSeaEnv(), 3)


CONFIGS = {
    "catch_muzero": "zoo.bsuite.config.catch_muzero_config",
    "deep_sea_muzero": "zoo.bsuite.config.deep_sea_muzero_config",
    "bsuite_efficientzero": "zoo.bsuite.config.bsuite_efficientzero_config",
    "memory_muzero": "zoo.memory.config.memory_muzero_config",
    "memory_efficientzero": "zoo.memory.config.memory_efficientzero_config",
}


def port_config(name):
    return importlib.import_module(f"lightzero_tpu_torch.configs.{name}").main_config


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_equals_the_zoo_file(name):
    zoo = importlib.import_module(CONFIGS[name]).main_config
    assert port_config(name).to_dict() == zoo.to_dict()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_trains_shrunk_through_the_port(tmp_path, name):
    cfg = Config(port_config(name).to_dict())
    cfg.exp_name = str(tmp_path / "exp")
    cfg.env = Config(dict(cfg.env, collector_env_num=2, evaluator_env_num=2,
                          n_evaluator_episode=2, stop_value=10_000))
    env = create_env(cfg.env)
    assert env.observation_shape == cfg.policy.model.observation_shape
    model = dict(cfg.policy.model, latent_state_dim=16, proj_hid=32, proj_out=32, pred_hid=16,
                 pred_out=32)
    if cfg.policy.type == "efficientzero":
        model["lstm_hidden_size"] = 16
    cfg.policy = Config(dict(cfg.policy, model=model, num_simulations=4, batch_size=8,
                             update_per_collect=2, n_episode=2, eval_freq=1000))
    policy, state, stats = train_muzero(cfg, seed=0, max_train_iter=2, device="cpu")
    assert stats["train_iter"] == 2 == state.train_iter
    assert stats["eval_env_steps"] > 0 and stats["buffer"].num_transitions >= 8
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert (stats["buffer"]._episodes[0].to_play == -1).all()


def test_rnd_config_is_refused(tmp_path):
    from zoo.memory.config.memory_muzero_rnd_config import main_config as zoo

    cfg = Config(zoo.to_dict())
    cfg.exp_name = str(tmp_path / "exp")
    # it trains through train_muzero_with_reward_model (tests/test_torch_rnd.py);
    # train_muzero refuses it where the JAX one trains without the bonus
    with pytest.raises(ValueError, match="ignores cfg.reward_model.*train_muzero_with_reward_model"):
        train_muzero(cfg, device="cpu")
