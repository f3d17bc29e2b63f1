"""Port vs JAX: Pendulum (lightzero_tpu_torch/envs/pendulum.py against
lightzero_tpu/envs/pendulum.py).

- One step from the same states and actions, 512 random states with random
  step counters (so some episodes end and reset), continuous and with
  ``discrete_bins``, at another gravity and torque too: the JAX reset states
  of the step's keys are handed to the port's transition. obs, reward and
  state to 1e-6 absolute (float32 sin, cos and the floor modulo of the
  cost, summed in another order); done, truncated, the step counter and
  the legal mask exact. Compared step by step from JAX's states, not along
  a rollout: the dynamics are chaotic, and rounding would grow.
- ``initial_state`` driven by JAX's own reset draws (the uniforms of the
  reset's key splits): θ and θ̇ to 1e-6.
- The env's own reset, truncation at ``max_episode_steps`` and auto-reset.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.envs.pendulum import PendulumEnv as JaxPendulum
from lightzero_tpu.envs.pendulum import PendulumState as JaxState
from lightzero_tpu_torch.envs.pendulum import (
    PendulumEnv,
    PendulumState,
    initial_state,
    observe,
)

pytestmark = pytest.mark.unittest

NUM = 512
TOL = 1e-6


def _port_state(s):
    return PendulumState(*(torch.from_numpy(np.array(x)) for x in s))


@pytest.mark.parametrize("kwargs", [dict(), dict(discrete_bins=11),
                                    dict(gravity=9.81, max_torque=1.5)],
                         ids=["continuous", "discrete_bins", "gravity_torque"])
def test_step_matches_jax(kwargs):
    jenv, env = JaxPendulum(max_episode_steps=50, **kwargs), PendulumEnv(max_episode_steps=50, **kwargs)
    jstep = jax.jit(jax.vmap(jenv.step))
    jreset = jax.jit(jax.vmap(jenv.reset))
    rng = np.random.default_rng(0)
    saw_done = False
    for i in range(3):
        state = JaxState(
            theta=jnp.asarray(rng.uniform(-12, 12, NUM).astype(np.float32)),
            theta_dot=jnp.asarray(rng.uniform(-8, 8, NUM).astype(np.float32)),
            t=jnp.asarray(rng.integers(0, 50, NUM).astype(np.int32)),
        )
        if env.continuous:
            # beyond [-1, 1] too, where the torque is clipped
            action = rng.uniform(-1.5, 1.5, (NUM, 1)).astype(np.float32)
        else:
            action = rng.integers(0, 11, NUM).astype(np.int32)
        keys = jax.random.split(jax.random.PRNGKey(i), NUM)
        exp = jstep(state, jnp.asarray(action), keys)
        got = env.transition(_port_state(state), torch.from_numpy(action),
                             _port_state(jreset(keys)[0]))
        for field in ("done", "truncated", "legal_mask", "to_play"):
            np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(exp, field)))
        assert got.legal_mask.shape == (NUM, 11 if "discrete_bins" in kwargs else 1)
        np.testing.assert_array_equal(got.state.t.numpy(), np.asarray(exp.state.t))
        for g, e in [(got.obs, exp.obs), (got.reward, exp.reward),
                     (got.state.theta, exp.state.theta), (got.state.theta_dot, exp.state.theta_dot)]:
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=TOL)
        assert got.chance is None
        saw_done |= bool(np.asarray(exp.done).any())
    assert saw_done


def test_initial_state_driven_by_jaxs_reset_draws():
    keys = jax.random.split(jax.random.PRNGKey(3), NUM)
    exp, exp_obs = jax.vmap(JaxPendulum().reset)(keys)
    u = np.stack([np.asarray(jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[i], ()))(keys))
                  for i in range(2)], axis=1)
    got = initial_state(torch.from_numpy(u))
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(exp.theta), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.theta_dot.numpy(), np.asarray(exp.theta_dot), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(exp.t))
    np.testing.assert_allclose(observe(got).numpy(), np.asarray(exp_obs), rtol=0, atol=TOL)


def test_env_truncates_and_resets_itself():
    env = PendulumEnv(max_episode_steps=3)
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(6, g)
    assert obs.shape == (6, 3) and (state.theta.abs() <= np.pi).all()
    assert (state.theta_dot.abs() <= 1).all()
    for t in range(3):
        step = env.step(state, torch.full((6, 1), 0.5), g)
        assert bool(step.done.any()) == (t == 2)
        state = step.state
    assert step.done.all() and step.truncated.all() and (step.state.t == 0).all()
    assert (step.state.theta.abs() <= np.pi).all() and (step.state.theta_dot.abs() <= 1).all()
    torch.testing.assert_close(step.obs, observe(step.state))
    assert (step.reward <= 0).all()
