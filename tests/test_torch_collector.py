"""Port vs JAX: the rollout collector (lightzero_tpu_torch/workers/collector.py
against lightzero_tpu/workers/collector.py).

The two packages' randomness streams differ, so both collectors drive the
same deterministic stub: an env whose episodes last 3 + p steps (p in 0..4,
odd p ends truncated, the next p drawn from the last action), a policy whose
action, visit counts and values are exact functions of the observation, and
the same initial env states. The episodes (every field), their priorities
|predicted - searched|, the env-step counts and the stats must then be
equal, in episode mode and in min_steps (segment) mode with the flush of
partial episodes. Then the port's collector on CartPole with its real
policy, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.envs.base import EnvStep as JaxEnvStep
from lightzero_tpu.envs.base import JaxEnv
from lightzero_tpu.workers.collector import RolloutCollector as JaxRolloutCollector
from lightzero_tpu_torch.envs import CartPoleEnv
from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.workers import RolloutCollector

pytestmark = pytest.mark.unittest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once: their thread pools would
    fight over the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NUM_ENVS = 3
ROLLOUT = 8
INITIAL_P = np.array([0, 3, 4], np.int32)
EPISODE_FIELDS = ("obs", "actions", "rewards", "child_visits", "root_values", "legal_mask",
                  "to_play", "chance")


class JaxStubEnv(JaxEnv):
    observation_shape = 2
    action_space_size = 2

    def reset(self, rng):
        state = (jnp.int32(0), jnp.int32(0))
        return state, self._obs(state)

    @staticmethod
    def _obs(state):
        return jnp.stack(state).astype(jnp.float32)

    def legal_mask(self, state):
        return jnp.ones(2, bool)

    def step(self, state, action, rng):
        t, p = state
        t = t + 1
        done = t >= 3 + p
        new = (jnp.where(done, 0, t), jnp.where(done, (p + 2 + action) % 5, p))
        return JaxEnvStep(
            state=new, obs=self._obs(new), reward=(action + 1).astype(jnp.float32) * 0.5,
            done=done, legal_mask=jnp.ones(2, bool), to_play=jnp.int32(-1),
            truncated=done & (p % 2 == 1),
        )


class StubEnv(TensorEnv):
    observation_shape = 2
    action_space_size = 2

    def reset(self, num_envs, generator):
        state = (torch.zeros(num_envs, dtype=torch.int32), torch.zeros(num_envs, dtype=torch.int32))
        return state, self._obs(state)

    @staticmethod
    def _obs(state):
        return torch.stack(state, -1).to(torch.float32)

    def legal_mask(self, state):
        return torch.ones((state[0].shape[0], 2), dtype=torch.bool)

    def step(self, state, action, generator):
        t, p = state
        t = t + 1
        done = t >= 3 + p
        new = (torch.where(done, 0, t).int(), torch.where(done, (p + 2 + action) % 5, p).int())
        B = t.shape[0]
        return EnvStep(
            state=new, obs=self._obs(new), reward=(action + 1).to(torch.float32) * 0.5,
            done=done, legal_mask=torch.ones((B, 2), dtype=torch.bool),
            to_play=torch.full((B,), -1, dtype=torch.int32), truncated=done & (p % 2 == 1),
        )


def _stub_outputs(obs, xp):
    t, p = obs[:, 0], obs[:, 1]
    return dict(
        action=(t + p) % 2,
        visit_counts=xp.stack([t + 1, p + 2], -1),
        searched_value=t * 0.5 + p,
        predicted_value=t * 0.25,
    )


class JaxStubPolicy:
    def _forward_collect(self, params, rng, obs, legal, to_play, temperature, epsilon,
                         deterministic=False):
        out = _stub_outputs(obs, jnp)
        out["action"] = out["action"].astype(jnp.int32)
        return out


class StubPolicy:
    def _forward_collect(self, obs, legal, to_play, temperature, epsilon, deterministic=False):
        out = _stub_outputs(obs, torch)
        out["action"] = out["action"].long()
        return out


def collectors(flush_min_len=8):
    jax_c = JaxRolloutCollector(JaxStubEnv(), JaxStubPolicy(), NUM_ENVS, rollout_length=ROLLOUT,
                                rng=jax.random.PRNGKey(0), flush_min_len=flush_min_len)
    c = RolloutCollector(StubEnv(), StubPolicy(), NUM_ENVS, rollout_length=ROLLOUT,
                         flush_min_len=flush_min_len, device="cpu")
    # the same initial states on both sides
    p = INITIAL_P
    jax_state = (jnp.zeros(NUM_ENVS, jnp.int32), jnp.asarray(p))
    jax_c._state = (jax_state, JaxStubEnv._obs(jax_state).T, jnp.ones((NUM_ENVS, 2), bool),
                    jnp.full((NUM_ENVS,), -1, jnp.int32), None)
    state = (torch.zeros(NUM_ENVS, dtype=torch.int32), torch.from_numpy(p))
    c._state = (state, StubEnv._obs(state), torch.ones((NUM_ENVS, 2), dtype=torch.bool),
                torch.full((NUM_ENVS,), -1, dtype=torch.int32))
    return jax_c, c


def check_same(got, exp):
    (episodes, priorities, stats), (jax_episodes, jax_priorities, jax_stats) = got, exp
    assert len(episodes) == len(jax_episodes) > 0
    for ep, jep in zip(episodes, jax_episodes):
        for f in EPISODE_FIELDS:
            np.testing.assert_array_equal(getattr(ep, f), np.asarray(getattr(jep, f)), err_msg=f)
            assert getattr(ep, f).dtype == np.asarray(getattr(jep, f)).dtype, f
        assert ep.truncated == jep.truncated
    for p, jp in zip(priorities, jax_priorities):
        np.testing.assert_array_equal(p, jp)
    for key in ("steps", "episodes", "mean_return", "visit_entropy", "searched_value"):
        np.testing.assert_allclose(stats[key], jax_stats[key], rtol=1e-12, err_msg=key)


def test_episode_mode_matches_jax():
    jax_c, c = collectors()
    for _ in range(3):  # builders carry partial episodes across calls
        exp = jax_c.collect(None, temperature=0.25, num_episodes=4)
        got = c.collect(temperature=0.25, num_episodes=4)
        check_same(got, exp)
        assert c.total_env_steps == jax_c.total_env_steps
        assert c.total_episodes == jax_c.total_episodes
    assert any(ep.truncated for ep in got[0]) and not all(ep.truncated for ep in got[0])
    assert c.total_env_steps % (ROLLOUT * NUM_ENVS) == 0


def test_segment_mode_flushes_as_jax():
    jax_c, c = collectors(flush_min_len=2)
    for _ in range(3):
        exp = jax_c.collect(None, min_steps=2 * ROLLOUT * NUM_ENVS)
        got = c.collect(min_steps=2 * ROLLOUT * NUM_ENVS)
        check_same(got, exp)
        assert got[2]["steps"] == 2 * ROLLOUT * NUM_ENVS
        assert c.total_env_steps == jax_c.total_env_steps


def test_collects_cartpole_with_the_search_policy():
    policy = MuZeroPolicy(dict(num_simulations=3, model=dict(latent_state_dim=16, support_scale=10)),
                          device="cpu")
    c = RolloutCollector(CartPoleEnv(max_episode_steps=10), policy, 2, rollout_length=16,
                         device="cpu")
    episodes, priorities, stats = c.collect(temperature=1.0, num_episodes=2)
    assert stats["steps"] == 32 and len(episodes) >= 2
    for ep, p in zip(episodes, priorities):
        T = len(ep.actions)
        assert 1 <= T <= 10 and ep.obs.shape == (T, 4) and p.shape == (T,)
        np.testing.assert_allclose(ep.child_visits.sum(-1), 1.0, rtol=1e-6)
        assert ep.truncated == (T == 10)
        assert np.all(np.isfinite(p)) and np.all(p >= 0)
