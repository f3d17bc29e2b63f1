"""Port vs JAX: the five MinAtar-class grid envs
(lightzero_tpu_torch/envs/{breakout_grid,minatar_like}.py against
lightzero_tpu/envs/{breakout_grid,minatar_like}.py).

Each env runs 8 episodes side by side in both packages for 300 steps of
numpy-seeded random actions (freeway's mostly up, so that the chicken
crosses), with ``max_steps`` cut to 60 (12 for breakout, whose ball is
lost within a few steps of random play) so that episodes end by the time
limit as well as by the game, and auto-reset. The JAX env
draws from its step key; the test makes the same draws from the same key
(the spawn lane and test, directions, the alien fire, a reset's traffic or
ball) and hands them to the port's ``transition``. Observations, rewards,
done and truncation flags, legal masks and to-play agree exactly at every
step (the observations are sums of a few exact floats), except seaquest's
oxygen plane, oxygen / oxygen_max, to one float32 ulp (XLA computes the
division by the constant as a product by its reciprocal)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.envs.breakout_grid import BreakoutGridEnv as JaxBreakout
from lightzero_tpu.envs.minatar_like import (
    AsterixGridEnv as JaxAsterix,
    FreewayGridEnv as JaxFreeway,
    SeaquestGridEnv as JaxSeaquest,
    SpaceInvadersGridEnv as JaxInvaders,
)
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry.train_muzero import ENVS, create_env
from lightzero_tpu_torch.envs import breakout_grid
from lightzero_tpu_torch.envs.minatar_like import (
    AsterixDraws,
    AsterixGridEnv,
    FreewayDraws,
    FreewayGridEnv,
    InvadersDraws,
    SeaquestDraws,
    SeaquestGridEnv,
    SpaceInvadersGridEnv,
)

pytestmark = pytest.mark.unittest

B, STEPS, MAX_STEPS, BREAKOUT_MAX_STEPS, S = 8, 300, 60, 12, 10
ULP = 1.2e-7


def _breakout_draws(key):
    c_rng, d_rng = jax.random.split(key)
    return jax.random.randint(c_rng, (), 0, S), jax.random.bernoulli(d_rng)


def _asterix_draws(key):
    r_spawn, r_dir, r_gold, _ = jax.random.split(key, 4)
    return (jax.random.randint(r_spawn, (), 0, 8), jax.random.uniform(r_spawn),
            jax.random.bernoulli(r_dir), jax.random.bernoulli(r_gold, 0.3))


def _freeway_draws(key):
    r1, r2, r3 = jax.random.split(key, 3)
    return (jax.random.randint(r1, (8,), 0, S), jax.random.randint(r2, (8,), 1, 4),
            jax.random.bernoulli(r3, 0.5, (8,)))


def _invaders_draws(key):
    r_fire, r_col, _ = jax.random.split(key, 3)
    return jax.random.bernoulli(r_fire, 0.3), jax.random.randint(r_col, (), 0, 6)


def _seaquest_draws(key):
    r_spawn, r_dir, _ = jax.random.split(key, 3)
    return (jax.random.randint(r_spawn, (), 0, 6), jax.random.uniform(r_spawn),
            jax.random.bernoulli(r_dir))


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x).copy())
    return t if dtype is None else t.to(dtype)


def _breakout():
    def draws(d):
        return breakout_grid.ResetDraws(_t(d[0], torch.int64), _t(d[1]))

    return (JaxBreakout(max_steps=BREAKOUT_MAX_STEPS), _breakout_draws, breakout_grid.observe,
            lambda d: breakout_grid.reset_state(draws(d)),
            lambda s, a, d: breakout_grid.transition(s, a, draws(d), BREAKOUT_MAX_STEPS))


def _asterix():
    env = AsterixGridEnv(max_steps=MAX_STEPS)
    return (JaxAsterix(max_steps=MAX_STEPS), _asterix_draws, env.observe,
            lambda d: env.initial_state(B, "cpu"),
            lambda s, a, d: env.transition(s, a, AsterixDraws(
                _t(d[0], torch.int64), _t(d[1]), _t(d[2]), _t(d[3]))))


def _freeway():
    env = FreewayGridEnv(max_steps=MAX_STEPS)

    def draws(d):
        return FreewayDraws(_t(d[0], torch.int64), _t(d[1], torch.int64), _t(d[2]))

    return (JaxFreeway(max_steps=MAX_STEPS), _freeway_draws, env.observe,
            lambda d: env.initial_state(draws(d)),
            lambda s, a, d: env.transition(s, a, draws(d)))


def _invaders():
    env = SpaceInvadersGridEnv(max_steps=MAX_STEPS)
    return (JaxInvaders(max_steps=MAX_STEPS), _invaders_draws, env.observe,
            lambda d: env.initial_state(B, "cpu"),
            lambda s, a, d: env.transition(s, a, InvadersDraws(_t(d[0]), _t(d[1], torch.int64))))


def _seaquest():
    env = SeaquestGridEnv(max_steps=MAX_STEPS)
    return (JaxSeaquest(max_steps=MAX_STEPS), _seaquest_draws, env.observe,
            lambda d: env.initial_state(B, "cpu"),
            lambda s, a, d: env.transition(s, a, SeaquestDraws(
                _t(d[0], torch.int64), _t(d[1]), _t(d[2]))))


ENV_CASES = {"breakout_grid": _breakout, "asterix_grid": _asterix, "freeway_grid": _freeway,
             "space_invaders_grid": _invaders, "seaquest_grid": _seaquest}


@pytest.mark.parametrize("env_id", list(ENV_CASES))
def test_grid_env_matches_jax_under_its_draws(env_id):
    jax_env, jax_draws, observe, port_reset, port_step = ENV_CASES[env_id]()
    draw = jax.jit(jax.vmap(jax_draws))
    reset = jax.jit(jax.vmap(jax_env.reset))
    step = jax.jit(jax.vmap(jax_env.step))
    key = jax.random.PRNGKey(0)
    key, sub = jax.random.split(key)
    reset_keys = jax.random.split(sub, B)
    jax_state, jax_obs = reset(reset_keys)
    state = port_reset(draw(reset_keys))
    np.testing.assert_allclose(observe(state).numpy(), np.asarray(jax_obs), rtol=ULP, atol=0)
    rng = np.random.default_rng(1)
    A = jax_env.action_space_size
    p = [0.15, 0.7, 0.15] if env_id == "freeway_grid" else [1 / A] * A
    ends = truncations = rewarded = 0
    for t in range(STEPS):
        actions = rng.choice(A, B, p=p)
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, B)
        exp = step(jax_state, jnp.asarray(actions, jnp.int32), keys)
        got = port_step(state, torch.from_numpy(actions), draw(keys))
        for field in ("obs", "reward", "done", "legal_mask", "to_play", "truncated"):
            g, e = getattr(got, field).numpy(), np.asarray(getattr(exp, field))
            if env_id == "seaquest_grid" and field == "obs":
                np.testing.assert_allclose(g[..., 3], e[..., 3], rtol=ULP, atol=0)
                g, e = g[..., :3], e[..., :3]
            np.testing.assert_array_equal(g, e, err_msg=f"{env_id} step {t} {field}")
        jax_state, state = exp.state, got.state
        ends += int(np.asarray(exp.done).sum())
        truncations += int((np.asarray(exp.done) & np.asarray(exp.truncated)).sum())
        rewarded += int((np.asarray(exp.reward) != 0).sum())
    # the run covered auto-resets and rewards
    assert ends >= B and rewarded > 0, (ends, rewarded)
    if env_id in ("breakout_grid", "freeway_grid"):
        assert truncations > 0


@pytest.mark.parametrize("env_id", list(ENV_CASES))
def test_grid_env_steps_from_its_generator(env_id):
    """Through ``reset``/``step`` with a generator: the same seed gives the
    same episodes, observations keep their shape and range, every action is
    legal, and ``max_steps`` reaches the env from the env config."""
    env = create_env(Config(dict(type=env_id, max_steps=25)))
    assert env.max_steps == 25 and env_id in ENVS
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        state, obs = env.reset(4, g)
        assert obs.shape == (4, *env.observation_shape) and obs.dtype == torch.float32
        total, dones = torch.zeros(4), 0
        for _ in range(60):
            st = env.step(state, torch.randint(0, env.action_space_size, (4,), generator=g), g)
            state = st.state
            total += st.reward
            dones += int(st.done.sum())
            assert st.legal_mask.all() and st.obs.min() >= 0 and st.obs.max() <= 2
        runs.append((total, dones, st.obs))
        assert dones >= 4  # 60 steps of a 25-step limit end every env's episode
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    assert torch.equal(runs[0][2], runs[1][2])
