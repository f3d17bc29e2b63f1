"""Port vs JAX: MuZero-Context (lightzero_tpu_torch/policy/muzero_context.py
and the stateful paths of workers/collector.py and workers/evaluator.py
against their counterparts in lightzero_tpu/), at small widths (latent 32,
support scale 10, 5 simulations), tie_break='first'.

Tolerances: visit counts and actions exact; root latents 1e-5 absolute
(float32 matmuls and LayerNorm statistics in another order); searched
values 1e-4 relative with a 1e-4 floor (ROADMAP queue 3).

- ``_forward_collect_stateful`` over 7 steps with deterministic=True: env 1
  ends its episode after step 2 (a per-env reset, encoded again at step 3),
  env 0 reaches timestep 5 (the context reset: encoded again at step 5);
  the root latents, the context states, visit counts, actions and searched
  values equal JAX's; one collect step with root noise, JAX's own Dirichlet
  draw injected, gives JAX's visit counts;
- the collector and the Evaluator thread a policy's per-env state as the
  JAX workers do: a deterministic stateful stub policy on the stub env of
  tests/test_torch_collector.py gives the same episodes and returns;
- train_muzero on a small MuZero-Context config on the CPU, every collect
  and eval search through the stateful path.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.policy.muzero_context import MuZeroContextPolicy as JaxContextPolicy
from lightzero_tpu.workers.collector import RolloutCollector as JaxRolloutCollector
from lightzero_tpu.workers.evaluator import Evaluator as JaxEvaluator
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import train_muzero
from lightzero_tpu_torch.policy import MuZeroContextPolicy
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from lightzero_tpu_torch.workers import Evaluator, RolloutCollector
from test_torch_collector import (
    INITIAL_P,
    NUM_ENVS,
    ROLLOUT,
    JaxStubEnv,
    StubEnv,
    _stub_outputs,
    check_same,
)
from test_torch_learn import SMALL
from test_torch_model import perturbed_params

pytestmark = pytest.mark.unittest

LATENT_TOL = 1e-5
VALUE_RTOL = VALUE_ATOL = 1e-4
STEPS = 7
CTX = 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_default_config_is_the_jax_default():
    assert (MuZeroContextPolicy.default_config().to_dict()
            == JaxContextPolicy.default_config().to_dict())


@pytest.fixture(scope="module")
def policies():
    cfg = jax_deep_merge(JaxContextPolicy.default_config(),
                         dict(SMALL, type="muzero_context", context_length_init=CTX))
    jax_policy = JaxContextPolicy(cfg)
    jax_policy.search_cfg = dataclasses.replace(jax_policy.search_cfg, tie_break="first")
    params = jax.tree_util.tree_map(jnp.asarray, perturbed_params(jax_policy.model, 7))
    port = MuZeroContextPolicy(dict(SMALL, context_length_init=CTX), device="cpu")
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    port.search_cfg = dataclasses.replace(port.search_cfg, tie_break="first")
    return jax_policy, params, port


def test_seven_stateful_steps_match_jax(policies):
    jax_policy, params, port = policies
    B, A = 3, 2
    rng = np.random.default_rng(3)
    legal = np.ones((B, A), bool)
    to_play = np.full(B, -1, np.int32)
    jstate = jax_policy.init_collect_state(B)
    state = port.init_collect_state(B)
    done_after = {2: np.array([False, True, False])}  # env 1's episode ends after step 2
    encoded_at = []
    for step in range(STEPS):
        obs = rng.standard_normal((B, 4)).astype(np.float32)
        exp, jstate = jax_policy._forward_collect_stateful(
            params, jax.random.PRNGKey(step), jnp.asarray(obs), jnp.asarray(legal),
            jnp.asarray(to_play), jnp.float32(1.0), jnp.float32(0.0), jstate, deterministic=True)
        got, state = port._forward_collect_stateful(
            torch.from_numpy(obs), torch.from_numpy(legal), torch.from_numpy(to_play), 1.0, 0.0,
            state, deterministic=True)
        np.testing.assert_allclose(state["latent"].numpy(), np.asarray(jstate["latent"]),
                                   rtol=0, atol=LATENT_TOL, err_msg=f"root latent, step {step}")
        for key in ("last_action", "timestep"):
            np.testing.assert_array_equal(state[key].numpy(), np.asarray(jstate[key]),
                                          err_msg=f"{key}, step {step}")
        for key in ("visit_counts", "action"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(exp[key]),
                                          err_msg=f"{key}, step {step}")
        np.testing.assert_allclose(got["searched_value"].numpy(), np.asarray(exp["searched_value"]),
                                   rtol=VALUE_RTOL, atol=VALUE_ATOL)
        with torch.no_grad():
            encoded = port.model.representation(torch.from_numpy(obs))
        encoded_at.append(torch.isclose(state["latent"], encoded, rtol=0, atol=1e-6)
                          .all(-1).numpy())
        if step in done_after:
            done = done_after[step]
            jstate = jax_policy.reset_collect_state(jstate, jnp.asarray(done))
            state = port.reset_collect_state(state, torch.from_numpy(done))
            np.testing.assert_array_equal(state["last_action"].numpy()[done], -1)
    encoded_at = np.stack(encoded_at)  # (step, env): the root latent is a fresh encoding
    np.testing.assert_array_equal(encoded_at[:, 0], [1, 0, 0, 0, 0, 1, 0])  # context reset
    np.testing.assert_array_equal(encoded_at[:, 1], [1, 0, 0, 1, 0, 0, 0])  # episode reset


def test_a_collect_step_with_root_noise_matches_jax(policies):
    jax_policy, params, port = policies
    B, A = 4, 2
    obs = np.random.default_rng(4).standard_normal((B, 4)).astype(np.float32)
    legal = np.ones((B, A), bool)
    key = jax.random.PRNGKey(9)
    exp, _ = jax_policy._forward_collect_stateful(
        params, key, jnp.asarray(obs), jnp.asarray(legal), jnp.full((B,), -1, jnp.int32),
        jnp.float32(1.0), jnp.float32(0.0), jax_policy.init_collect_state(B))
    # the policy splits its key five ways and searches with the second part;
    # the search splits that once and draws Gamma(alpha) with the second half
    _, s_rng, *_ = jax.random.split(key, 5)
    _, prep = jax.random.split(s_rng)
    g = np.asarray(jax.random.gamma(prep, float(jax_policy.cfg.root_dirichlet_alpha), (B, A),
                                    jnp.float32))
    got, _ = port._forward_collect_stateful(
        torch.from_numpy(obs), torch.from_numpy(legal), torch.full((B,), -1, dtype=torch.int32),
        1.0, 0.0, port.init_collect_state(B), noise=torch.from_numpy(g / g.sum(-1, keepdims=True)))
    np.testing.assert_array_equal(got["visit_counts"].numpy(), np.asarray(exp["visit_counts"]))
    np.testing.assert_allclose(got["searched_value"].numpy(), np.asarray(exp["searched_value"]),
                               rtol=VALUE_RTOL, atol=VALUE_ATOL)


# ------------------------------------------------- the workers' stateful path


def _stateful_outputs(obs, count, deterministic, xp):
    """tests/test_torch_collector.py's stub outputs, shifted by the per-env
    step count since the last reset and by the deterministic flag."""
    out = _stub_outputs(obs, xp)
    out["action"] = (out["action"] + count + int(deterministic)) % 2
    out["searched_value"] = out["searched_value"] + count * 0.25
    return out


class JaxStatefulStub:
    stateful_collect = True

    def init_collect_state(self, n):
        return dict(count=jnp.zeros(n, jnp.float32))

    def reset_collect_state(self, state, done):
        return dict(count=jnp.where(done, 0.0, state["count"]))

    def _forward_collect_stateful(self, params, rng, obs, legal, to_play, temperature, epsilon,
                                  collect_state, deterministic=False):
        out = _stateful_outputs(obs, collect_state["count"], deterministic, jnp)
        out["action"] = out["action"].astype(jnp.int32)
        return out, dict(count=collect_state["count"] + 1)


class StatefulStub:
    stateful_collect = True

    def init_collect_state(self, n):
        return dict(count=torch.zeros(n))

    def reset_collect_state(self, state, done):
        return dict(count=torch.where(done, 0.0, state["count"]))

    def _forward_collect_stateful(self, obs, legal, to_play, temperature, epsilon, collect_state,
                                  deterministic=False):
        out = _stateful_outputs(obs, collect_state["count"], deterministic, torch)
        out["action"] = out["action"].long()
        return out, dict(count=collect_state["count"] + 1)


def test_the_collector_threads_the_state_as_jax():
    jax_c = JaxRolloutCollector(JaxStubEnv(), JaxStatefulStub(), NUM_ENVS, rollout_length=ROLLOUT,
                                rng=jax.random.PRNGKey(0))
    c = RolloutCollector(StubEnv(), StatefulStub(), NUM_ENVS, rollout_length=ROLLOUT, device="cpu")
    jax_state = (jnp.zeros(NUM_ENVS, jnp.int32), jnp.asarray(INITIAL_P))
    jax_c._state = (jax_state, JaxStubEnv._obs(jax_state).T, jnp.ones((NUM_ENVS, 2), bool),
                    jnp.full((NUM_ENVS,), -1, jnp.int32), JaxStatefulStub().init_collect_state(NUM_ENVS))
    state = (torch.zeros(NUM_ENVS, dtype=torch.int32), torch.from_numpy(INITIAL_P))
    c._state = (state, StubEnv._obs(state), torch.ones((NUM_ENVS, 2), dtype=torch.bool),
                torch.full((NUM_ENVS,), -1, dtype=torch.int32))
    for _ in range(3):  # the state carries across calls
        exp = jax_c.collect(None, temperature=0.25, num_episodes=4)
        got = c.collect(temperature=0.25, num_episodes=4)
        check_same(got, exp)
    # the count restarted at every episode end: no stored value reaches a
    # count of the whole run
    assert max(float(ep.root_values.max()) for ep in got[0]) < 10


def test_the_evaluator_threads_the_state_as_jax():
    jax_ev = JaxEvaluator(JaxStubEnv(), JaxStatefulStub(), NUM_ENVS, rollout_length=ROLLOUT,
                          rng=jax.random.PRNGKey(0))
    ev = Evaluator(StubEnv(), StatefulStub(), NUM_ENVS, device="cpu")
    exp = jax_ev.eval(None)
    got = ev.eval()
    assert len(got["episode_returns"]) >= NUM_ENVS
    np.testing.assert_array_equal(got["episode_returns"],
                                  exp["episode_returns"][:len(got["episode_returns"])])


def tiny_cfg(exp_dir):
    return Config(dict(
        exp_name=str(exp_dir),
        env=dict(env_id="CartPole-v0", stop_value=10_000, collector_env_num=2,
                 evaluator_env_num=2, n_evaluator_episode=2),
        policy=dict(type="muzero_context", model=SMALL["model"], num_simulations=5,
                    batch_size=16, update_per_collect=4, n_episode=2, eval_freq=1000,
                    ssl_loss_weight=2, context_length_init=CTX),
    ))


def test_train_muzero_trains_muzero_context_on_the_cpu(tmp_path, monkeypatch):
    calls = {True: 0, False: 0}
    stateful = MuZeroContextPolicy._forward_collect_stateful

    def counting(self, *args, deterministic=False, **kwargs):
        calls[deterministic] += 1
        return stateful(self, *args, deterministic=deterministic, **kwargs)

    monkeypatch.setattr(MuZeroContextPolicy, "_forward_collect_stateful", counting)
    policy, state, stats = train_muzero(tiny_cfg(tmp_path / "exp"), seed=0, max_env_step=200,
                                        device="cpu")
    assert isinstance(policy, MuZeroContextPolicy)
    assert stats["env_steps"] == 256 and stats["train_iter"] == 8
    assert calls == {False: stats["env_steps"] // 2, True: stats["eval_env_steps"]}
    assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())


def test_cartpole_config_is_the_zoo_config():
    from lightzero_tpu_torch.configs.cartpole_muzero_context import main_config
    from zoo.classic_control.cartpole.config.cartpole_muzero_context_config import (
        main_config as zoo_config,
    )

    assert main_config.to_dict() == JaxConfig(zoo_config).to_dict()
