"""Port vs JAX: the collector and evaluator over host envs
(lightzero_tpu_torch/workers/host_collector.py against
lightzero_tpu/workers/host_collector.py).

The two packages' randomness streams differ, so both sides drive the same
deterministic stubs, as tests/test_torch_collector.py does: a numpy host env
with HostVecEnv's interface whose episodes last 3 + p steps (p in 0..4, the
next p drawn from the last action), and a policy whose action, visit counts
and values are exact functions of the observation and of ``deterministic``
(and, on the stateful path, of a per-env step count that resets with the
episode). The episodes (every field), their priorities |predicted -
searched|, the env-step counts and the stats must then be equal, in episode
mode, in min_steps mode and on the stateful path; the evaluator's returns
and records too.

Then the time-limit quirk: an episode that gymnasium's TimeLimit cut is
recorded as not truncated by both packages' host collectors, where the
rollout collector keeps the flag (ROADMAP queue 3). And the port's host
workers with the real MuZero policy on gymnasium's CartPole, on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.envs.host_env import HostVecEnv as JaxHostVecEnv
from lightzero_tpu.workers.host_collector import HostCollector as JaxHostCollector
from lightzero_tpu.workers.host_collector import HostEvaluator as JaxHostEvaluator
from lightzero_tpu_torch.envs import CartPoleEnv
from lightzero_tpu_torch.envs.host_env import HostVecEnv
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.workers import HostCollector, HostEvaluator, RolloutCollector

pytestmark = pytest.mark.unittest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NUM_ENVS = 3
INITIAL_P = np.array([0, 3, 4], np.int64)
EPISODE_FIELDS = ("obs", "actions", "rewards", "child_visits", "root_values", "legal_mask",
                  "to_play", "chance")


class StubHostEnv:
    """HostVecEnv's interface over (t, p) states: an episode lasts 3 + p
    steps, the reward is (action + 1) / 2, and the next episode's p is
    (p + 2 + the last action) % 5."""

    observation_shape = 2
    action_space_size = 2
    continuous = False

    def __init__(self, num_envs=NUM_ENVS):
        self.num_envs = num_envs

    def _obs(self):
        return np.stack([self.t, self.p], -1).astype(np.float32)

    def reset_all(self):
        self.t = np.zeros(self.num_envs, np.int64)
        self.p = INITIAL_P[: self.num_envs].copy()
        return self._obs(), np.ones((self.num_envs, 2), bool), np.full(self.num_envs, -1, np.int64)

    def step(self, actions):
        a = np.asarray(actions).astype(np.int64)
        self.t = self.t + 1
        done = self.t >= 3 + self.p
        self.p = np.where(done, (self.p + 2 + a) % 5, self.p)
        self.t = np.where(done, 0, self.t)
        return (self._obs(), ((a + 1) * 0.5).astype(np.float32), done,
                np.ones((self.num_envs, 2), bool), np.full(self.num_envs, -1, np.int64))


def _stub_outputs(obs, deterministic, xp, count=None):
    t, p = obs[:, 0], obs[:, 1]
    extra = 0 if count is None else count
    return dict(
        action=(t + p + extra + (1 if deterministic else 0)) % 2,
        visit_counts=xp.stack([t + 1, p + 2 + extra], -1),
        searched_value=t * 0.5 + p,
        predicted_value=t * 0.25 + extra,
    )


class JaxStubPolicy:
    def __init__(self, stateful=False):
        self.stateful_collect = stateful
        self._jit_collect = self._forward_collect

    def _forward_collect(self, params, rng, obs, legal, to_play, temperature, epsilon,
                         deterministic=False):
        out = _stub_outputs(obs, deterministic, jnp)
        out["action"] = out["action"].astype(jnp.int32)
        return out

    def _forward_collect_stateful(self, params, rng, obs, legal, to_play, temperature, epsilon,
                                  state, deterministic=False):
        out = _stub_outputs(obs, deterministic, jnp, count=state.astype(jnp.float32))
        out["action"] = out["action"].astype(jnp.int32)
        return out, state + 1

    def init_collect_state(self, n):
        return jnp.zeros(n, jnp.int32)

    def reset_collect_state(self, state, done):
        return jnp.where(done, 0, state)


class StubPolicy:
    def __init__(self, stateful=False):
        self.stateful_collect = stateful

    def _forward_collect(self, obs, legal, to_play, temperature, epsilon, deterministic=False):
        out = _stub_outputs(obs, deterministic, torch)
        out["action"] = out["action"].long()
        return out

    def _forward_collect_stateful(self, obs, legal, to_play, temperature, epsilon, state,
                                  deterministic=False):
        out = _stub_outputs(obs, deterministic, torch, count=state.float())
        out["action"] = out["action"].long()
        return out, state + 1

    def init_collect_state(self, n):
        return torch.zeros(n, dtype=torch.int32)

    def reset_collect_state(self, state, done):
        return torch.where(done, 0, state)


def workers(stateful=False):
    jax_c = JaxHostCollector(StubHostEnv(), JaxStubPolicy(stateful), rng=jax.random.PRNGKey(0))
    c = HostCollector(StubHostEnv(), StubPolicy(stateful), device="cpu")
    jax_e = JaxHostEvaluator(StubHostEnv(), JaxStubPolicy(stateful), rng=jax.random.PRNGKey(1))
    e = HostEvaluator(StubHostEnv(), StubPolicy(stateful), device="cpu")
    return jax_c, c, jax_e, e


def check_same(got, exp):
    (episodes, priorities, stats), (jax_episodes, jax_priorities, jax_stats) = got, exp
    assert len(episodes) == len(jax_episodes) > 0
    for ep, jep in zip(episodes, jax_episodes):
        for f in EPISODE_FIELDS:
            np.testing.assert_array_equal(getattr(ep, f), np.asarray(getattr(jep, f)), err_msg=f)
            assert getattr(ep, f).dtype == np.asarray(getattr(jep, f)).dtype, f
        assert ep.truncated is jep.truncated is False
        assert ep.root_sampled_actions is jep.root_sampled_actions is None
    for p, jp in zip(priorities, jax_priorities):
        np.testing.assert_array_equal(p, jp)
        assert p.dtype == jp.dtype
    assert set(stats) == set(jax_stats)
    for key in ("steps", "episodes", "mean_return"):
        assert stats[key] == jax_stats[key], key


@pytest.mark.parametrize("stateful", [False, True], ids=["plain", "stateful"])
def test_episode_mode_matches_jax(stateful):
    jax_c, c, _, _ = workers(stateful)
    for _ in range(3):  # builders carry partial episodes across calls
        exp = jax_c.collect(None, temperature=0.25, num_episodes=4)
        got = c.collect(temperature=0.25, num_episodes=4)
        check_same(got, exp)
        assert c.total_env_steps == jax_c.total_env_steps
        assert c.total_episodes == jax_c.total_episodes
        assert c.episode_returns == jax_c.episode_returns


@pytest.mark.parametrize("stateful", [False, True], ids=["plain", "stateful"])
def test_min_steps_mode_matches_jax(stateful):
    jax_c, c, _, _ = workers(stateful)
    for _ in range(3):
        exp = jax_c.collect(None, min_steps=10)
        got = c.collect(min_steps=10)
        check_same(got, exp)
        assert got[2]["steps"] == 12  # 4 batched steps of 3 envs
        assert c.total_env_steps == jax_c.total_env_steps


@pytest.mark.parametrize("stateful", [False, True], ids=["plain", "stateful"])
def test_evaluator_matches_jax(stateful):
    _, _, jax_e, e = workers(stateful)
    for n in (None, 5):
        exp = jax_e.eval(None, n_episodes=n)
        got = e.eval(n_episodes=n)
        for key in ("episode_returns", "mean_return", "max_return", "min_return", "new_best"):
            assert got[key] == exp[key], key
        assert set(got) == set(exp) | {"env_steps"}
        assert got["env_steps"] >= 3
    assert e.best_return == jax_e.best_return


class CartPoleStub:
    """A policy of fixed outputs for CartPole observations."""

    def _forward_collect(self, obs, legal, to_play, temperature, epsilon, deterministic=False,
                         **_):
        B = obs.shape[0]
        xp = jnp if isinstance(obs, jax.Array) else torch
        out = dict(action=xp.zeros(B, dtype=xp.int32 if xp is jnp else torch.int64),
                   visit_counts=xp.ones((B, 2)), searched_value=xp.zeros(B),
                   predicted_value=xp.zeros(B))
        return out


class JaxCartPoleStub(CartPoleStub):
    def __init__(self):
        self._jit_collect = lambda params, rng, *args, **kw: self._forward_collect(*args, **kw)


def test_time_limited_episodes_are_recorded_not_truncated_as_in_jax():
    """gymnasium's CartPole-v1 cut at 4 steps by its TimeLimit (pushing
    left from upright does not fail that fast): both host collectors record
    the cut episodes as not truncated (JAX workers/host_collector.py:77);
    the rollout collector over the tensor CartPole keeps the flag."""
    kwargs = dict(max_episode_steps=4)
    jax_c = JaxHostCollector(JaxHostVecEnv("CartPole-v1", 2, seed=0, env_kwargs=kwargs),
                             JaxCartPoleStub(), rng=jax.random.PRNGKey(0))
    c = HostCollector(HostVecEnv("CartPole-v1", 2, seed=0, env_kwargs=kwargs), CartPoleStub(),
                      device="cpu")
    jax_eps, _, _ = jax_c.collect(None, num_episodes=2)
    eps, _, _ = c.collect(num_episodes=2)
    assert [len(e.actions) for e in eps] == [len(e.actions) for e in jax_eps] == [4, 4]
    assert [e.truncated for e in eps] == [e.truncated for e in jax_eps] == [False, False]
    rollout = RolloutCollector(CartPoleEnv(max_episode_steps=4), CartPoleStub(), 2,
                               rollout_length=4, device="cpu")
    eps, _, _ = rollout.collect(num_episodes=2)
    assert [e.truncated for e in eps] == [True, True]


def test_host_workers_with_the_search_policy_on_gymnasium_cartpole():
    policy = MuZeroPolicy(dict(num_simulations=3, model=dict(latent_state_dim=16,
                                                             support_scale=10)), device="cpu")
    env = HostVecEnv("CartPole-v1", 2, seed=0, env_kwargs=dict(max_episode_steps=10))
    c = HostCollector(env, policy, device="cpu")
    episodes, priorities, stats = c.collect(temperature=1.0, num_episodes=2)
    assert stats["episodes"] == len(episodes) >= 2 and stats["steps"] == c.total_env_steps
    for ep, p in zip(episodes, priorities):
        T = len(ep.actions)
        assert 1 <= T <= 10 and ep.obs.shape == (T, 4) and p.shape == (T,)
        np.testing.assert_allclose(ep.child_visits.sum(-1), 1.0, rtol=1e-6)
        assert ep.actions.dtype == np.int64 and np.all(np.isfinite(p))
    res = HostEvaluator(HostVecEnv("CartPole-v1", 2, seed=777,
                                   env_kwargs=dict(max_episode_steps=10)),
                        policy, device="cpu").eval()
    assert len(res["episode_returns"]) == 2 and 1 <= res["mean_return"] <= 10
    assert 1 <= res["env_steps"] <= 10
