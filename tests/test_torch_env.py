"""Port vs JAX: CartPole (lightzero_tpu_torch/envs/cartpole.py against
lightzero_tpu/envs/cartpole.py) for the same states and actions, including
the auto-reset step: the JAX reset values for the step's key are handed to
the port's transition as its reset state, since the two generators differ.

done and truncated are exact; obs to 1e-6 (sin/cos of float32 differ in the
last bit between XLA and PyTorch)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.envs.cartpole import CartPoleEnv as JaxCartPole
from lightzero_tpu.envs.cartpole import CartPoleState as JaxState
from lightzero_tpu_torch.envs.cartpole import (
    CartPoleEnv,
    CartPoleState,
    initial_state,
    transition,
)

pytestmark = pytest.mark.unittest

NUM = 16


def test_rollout_with_auto_reset_matches_jax():
    rng = np.random.default_rng(0)
    jenv = JaxCartPole(max_episode_steps=30)
    vals = rng.uniform(-0.2, 0.2, (NUM, 4)).astype(np.float32)
    t0 = rng.integers(0, 25, NUM).astype(np.int32)
    jstate = JaxState(*(jnp.asarray(vals[:, i]) for i in range(4)), jnp.asarray(t0))
    pstate = CartPoleState(*(torch.from_numpy(vals[:, i]) for i in range(4)), torch.from_numpy(t0))
    jstep = jax.jit(jax.vmap(jenv.step))
    jreset = jax.vmap(jenv.reset)
    key = jax.random.PRNGKey(0)
    saw_fail = saw_trunc = False
    for _ in range(40):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, NUM)
        action = rng.integers(0, 2, NUM).astype(np.int32)
        exp = jstep(jstate, jnp.asarray(action), keys)
        reset_vals = np.stack([np.asarray(x) for x in jreset(keys)[0][:4]], axis=1)
        got = transition(pstate, torch.from_numpy(action), initial_state(torch.from_numpy(reset_vals)),
                         max_episode_steps=30)
        np.testing.assert_array_equal(got.done.numpy(), np.asarray(exp.done))
        np.testing.assert_array_equal(got.truncated.numpy(), np.asarray(exp.truncated))
        np.testing.assert_array_equal(got.reward.numpy(), np.asarray(exp.reward))
        np.testing.assert_array_equal(got.state.t.numpy(), np.asarray(exp.state.t))
        np.testing.assert_array_equal(got.legal_mask.numpy(), np.asarray(exp.legal_mask))
        np.testing.assert_allclose(got.obs.numpy(), np.asarray(exp.obs), rtol=1e-6, atol=1e-6)
        done = np.asarray(exp.done)
        saw_trunc |= bool(np.asarray(exp.truncated).any())
        saw_fail |= bool((done & ~np.asarray(exp.truncated)).any())
        # carry both sides on from the JAX state so that rounding never drifts
        jstate = exp.state
        pstate = CartPoleState(*(torch.from_numpy(np.array(x)) for x in exp.state))
    assert saw_fail and saw_trunc


def test_env_resets_itself_from_its_generator():
    env = CartPoleEnv(max_episode_steps=3)
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(4, g)
    assert obs.shape == (4, 4) and obs.abs().max() <= 0.05
    for t in range(3):
        step = env.step(state, torch.ones(4, dtype=torch.long), g)
        state = step.state
    assert step.done.all() and step.truncated.all()
    assert (step.state.t == 0).all() and step.obs.abs().max() <= 0.05
