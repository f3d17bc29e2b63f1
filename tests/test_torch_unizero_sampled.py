"""Port vs JAX: Sampled UniZero (lightzero_tpu_torch/policy/sampled_unizero.py
against lightzero_tpu/policy/sampled_unizero.py), continuous (Pendulum's
observation 3, action dimension 1) and discrete (6 actions), at small widths:
embed 32, 2 layers, 4 heads, K = 3 candidates, supports of 21 atoms (scale
10), 5 simulations, 3 unroll steps. The flax weights are perturbed from a
numpy seed and carried across with utils/params_import.py.

- The default config equals the JAX policy's.
- ``_forward_collect_stateful`` over 3 steps from a per-env KV cache, with
  the root's and every simulation's candidate draws rebuilt from JAX's
  keys (policy/sampled_unizero.py:105, then search/puct.py:781,789),
  tie_break 'first': two eval steps (the chosen slots, actions and the
  contexts equal, actions and contexts 1e-5 when continuous), then a
  collect step with the root's Dirichlet noise rebuilt too (K=3 slots and 5
  visits tie often, and each side draws among tied slots from its own
  generator, so the chosen slot is not compared there). At every step the
  visit counts and the trees' children and visits equal; the candidates (a
  tanh, which XLA rounds up to 4 ulp off), the K-slot embedding
  ``sampled_actions`` of every node and the priors 1e-5, exactly when
  discrete; values 1e-4 relative with a 1e-4 floor; the last search's
  per-node caches 1e-5.
- Two learn steps against the JAX learn step (jitted) from the same params,
  continuous and discrete, ``normalize_prob_of_sampled_actions`` on: the
  logged terms 1e-5 relative (1e-6 floor), but the mean predicted value and
  the priorities, held as the searches' values are (1e-4 relative and
  floor: h^-1 of a 21-atom expectation, from params that differ within the
  criterion after a step); the params under
  tests/test_torch_unizero_policy.py's criterion. The stored candidates stay
  within +-0.95: at +-1 XLA's compiled loss rewrites log(1 - a^2 + 1e-6)
  (tests/test_torch_sampled.py).
- Reanalyze is refused, as the JAX policy's cannot search K slots.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.policy.muzero import TrainBatch as JaxTrainBatch
from lightzero_tpu.policy.muzero import TrainState as JaxTrainState
from lightzero_tpu.policy.sampled_muzero import SampledTrainBatch as JaxSampledTrainBatch
from lightzero_tpu.policy.sampled_unizero import SampledUniZeroPolicy as JaxSampledUniZero
from lightzero_tpu_torch.policy import SampledUniZeroPolicy
from lightzero_tpu_torch.policy.muzero import TrainBatch
from lightzero_tpu_torch.policy.sampled_muzero import SampledTrainBatch
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from test_torch_unizero_policy import (
    adam_scale_seen,
    assert_params_close,
    check_logs,
    perturb,
    values_close,
)

pytestmark = pytest.mark.unittest

SIMS, KS, DISCRETE_A, UNROLL, LR = 5, 3, 6, 3, 1e-3
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfg(discrete: bool) -> dict:
    return dict(
        model=dict(observation_shape=3, action_space_size=DISCRETE_A if discrete else 1,
                   continuous_action_space=not discrete, embed_dim=32, num_layers=2,
                   num_heads=4, max_tokens=16, support_scale=10),
        num_simulations=SIMS, num_of_sampled_actions=KS, num_unroll_steps=UNROLL, batch_size=8,
        learning_rate=LR, sampled_node_prior="density", weight_decay=1e-2,
    )


def make_policies(discrete: bool, seed: int):
    c = cfg(discrete)
    jax_policy = JaxSampledUniZero(jax_deep_merge(JaxSampledUniZero.default_config(), c))
    params = perturb(jax_policy.model.init_params(jax.random.PRNGKey(seed)), seed)
    port = SampledUniZeroPolicy(c, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    for p in (jax_policy, port):
        p.search_cfg = dataclasses.replace(p.search_cfg, tie_break="first")
    return jax_policy, jax.tree_util.tree_map(jnp.asarray, params), port


def close(got, exp, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=tol, atol=tol)


def test_default_config_is_the_jax_default():
    assert (SampledUniZeroPolicy.default_config().to_dict()
            == JaxSampledUniZero.default_config().to_dict())


def jax_draws(key, B, discrete):
    """The draws of JAX's _forward_collect_stateful from its key: the root's
    candidates, each simulation's, and the root's Dirichlet noise over the
    K slots."""
    def draw(k):
        if discrete:
            return jax.random.gumbel(k, (B, DISCRETE_A), jnp.float32)
        return jax.random.normal(k, (B, KS, 1), jnp.float32)

    _, r_rng, s_rng, _ = jax.random.split(key, 4)
    rng, prep_rng = jax.random.split(s_rng)
    per_sim = []
    for _ in range(SIMS):
        rng, _, m_rng = jax.random.split(rng, 3)
        per_sim.append(np.asarray(draw(m_rng)))
    g = jax.random.gamma(prep_rng, 0.3, (B, KS), jnp.float32)
    noise = g / jnp.sum(g, axis=-1, keepdims=True)
    return (torch.from_numpy(np.array(draw(r_rng))), torch.from_numpy(np.stack(per_sim)),
            torch.from_numpy(np.array(noise)))


class _Keep:
    def __init__(self, fn):
        self.fn, self.out = fn, None

    def __call__(self, *args, **kwargs):
        self.out = self.fn(*args, **kwargs)
        return self.out


@pytest.mark.parametrize("discrete", [False, True], ids=["continuous", "discrete"])
def test_stateful_collect_searches_as_jax(monkeypatch, discrete):
    from lightzero_tpu.policy import sampled_unizero as jax_module
    from lightzero_tpu_torch.policy import sampled_unizero as port_module

    jax_policy, params, port = make_policies(discrete, seed=1)
    B, steps = 3, 3
    A = DISCRETE_A if discrete else 1
    jax_keep = _Keep(jax_module.batch_puct_search)
    monkeypatch.setattr(jax_module, "batch_puct_search", jax_keep)
    port_keep = _Keep(port_module.batch_puct_search)
    monkeypatch.setattr(port_module, "batch_puct_search", port_keep)
    rng = np.random.default_rng(1)
    legal = np.ones((B, A), bool)
    to_play = np.full(B, -1, np.int32)
    jstate, state = jax_policy.init_collect_state(B), port.init_collect_state(B)
    for t in range(steps):
        # eval steps (argmax, first of ties on both sides) keep the contexts
        # alike; the last step collects with root noise, where a slot is
        # drawn among tied counts on each side
        collect = t == steps - 1
        obs = (rng.standard_normal((B, 3)) * np.array([1, 1, 3])).astype(np.float32)
        key = jax.random.PRNGKey(10 + t)
        root_draws, sim_draws, noise = jax_draws(key, B, discrete)
        exp, jstate = jax_policy._forward_collect_stateful(
            params, key, jnp.asarray(obs), jnp.asarray(legal), jnp.asarray(to_play), 1.0, 0.0,
            jstate, deterministic=not collect)
        got, state = port._forward_collect_stateful(
            torch.from_numpy(obs), torch.from_numpy(legal), torch.from_numpy(to_play), 1.0, 0.0,
            state, deterministic=not collect, noise=noise if collect else None,
            root_draws=root_draws, sim_draws=sim_draws)
        tree, jtree = port_keep.out.tree, jax_keep.out.tree
        np.testing.assert_array_equal(got["visit_counts"].numpy(), np.asarray(exp["visit_counts"]))
        np.testing.assert_array_equal(tree.children.numpy(), np.asarray(jtree.children))
        np.testing.assert_array_equal(tree.visit_count.numpy(), np.asarray(jtree.visit_count))
        if not collect:
            np.testing.assert_array_equal(got["chosen_slot"].numpy(),
                                          np.asarray(exp["chosen_slot"]))
            if discrete:
                np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
            else:
                close(got["action"], exp["action"])
            close(state.k, jstate.k)
            np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
        if discrete:
            np.testing.assert_array_equal(got["root_sampled_actions"].numpy(),
                                          np.asarray(exp["root_sampled_actions"]))
            np.testing.assert_array_equal(tree.embedding["sampled_actions"].numpy(),
                                          np.asarray(jtree.embedding["sampled_actions"]))
        else:
            close(got["root_sampled_actions"], exp["root_sampled_actions"])
            close(tree.embedding["sampled_actions"], jtree.embedding["sampled_actions"])
        close(tree.prior, jtree.prior)
        for k in ("searched_value", "predicted_value"):
            values_close(got[k], exp[k])
    # every node of the last search carries its own cache: (B, N, L, H, Tc, Dh)
    assert tree.embedding["cache"].k.shape == (B, SIMS + 1, 2, 4, 16, 8)
    close(tree.embedding["cache"].k, jtree.embedding["cache"].k)


def sampled_batch(seed, discrete, B=8, K=UNROLL):
    rng = np.random.default_rng(seed)
    steps_left = rng.integers(0, K + 1, B)
    mask = (np.arange(K)[None] < steps_left[:, None]).astype(np.float32)
    policy = rng.dirichlet(np.ones(KS), (B, K + 1)).astype(np.float32)
    if discrete:
        actions = rng.integers(0, DISCRETE_A, (B, K)).astype(np.int64)
        sampled = np.stack([[rng.permutation(DISCRETE_A)[:KS] for _ in range(K + 1)]
                            for _ in range(B)]).astype(np.float32)
    else:
        actions = rng.uniform(-1, 1, (B, K, 1)).astype(np.float32)
        sampled = rng.uniform(-0.95, 0.95, (B, K + 1, KS, 1)).astype(np.float32)
    return dict(
        obs=rng.standard_normal((B, K + 1, 3)).astype(np.float32),
        actions=actions, mask=mask,
        target_reward=rng.uniform(-8, 0, (B, K)).astype(np.float32),
        target_value=rng.uniform(-30, 10, (B, K + 1)).astype(np.float32),
        target_policy=policy,
        weights=rng.uniform(0.2, 1.0, B).astype(np.float32),
        sampled_actions=sampled,
    )


def as_jax(b):
    base = {k: jnp.asarray(v.astype(np.int32) if k == "actions" and v.dtype.kind == "i" else v)
            for k, v in b.items() if k != "sampled_actions"}
    return JaxSampledTrainBatch(base=JaxTrainBatch(**base),
                                sampled_actions=jnp.asarray(b["sampled_actions"]))


def as_port(b):
    base = {k: torch.from_numpy(v) for k, v in b.items() if k != "sampled_actions"}
    return SampledTrainBatch(base=TrainBatch(**base),
                             sampled_actions=torch.from_numpy(b["sampled_actions"]))


@pytest.mark.parametrize("discrete", [False, True], ids=["continuous", "discrete"])
def test_learn_steps_match_jax(discrete):
    jax_policy, params, port = make_policies(discrete, seed=2)
    jax_state = JaxTrainState(params=params,
                              target_params=jax.tree_util.tree_map(jnp.copy, params),
                              opt_state=jax_policy.optimizer.init(params),
                              train_iter=jnp.zeros((), jnp.int32))
    state = port.init_train_state()
    seen = None
    for step in range(2):
        b = sampled_batch(30 + step, discrete)
        seen, held = adam_scale_seen(jax_policy, jax_state.params, as_jax(b), step, seen)
        jax_state, jax_logs, jax_prio = jax_policy.forward_learn(jax_state, as_jax(b))
        state, logs, prio = port.forward_learn(state, as_port(b))
        # the mean predicted value is h^-1 of a 21-atom expectation: after a
        # step the params differ within the criterion, so it is held as the
        # searches' values are
        values_close(logs.pop("predicted_value"), jax_logs.pop("predicted_value"))
        check_logs(logs, jax_logs)
        np.testing.assert_allclose(prio.numpy(), np.asarray(jax_prio), rtol=1e-4, atol=1e-4)
        assert_params_close(port.model, jax_state.params, held, lr=LR)


def test_reanalyze_is_refused():
    c = dict(cfg(False), reanalyze_ratio=0.25)
    with pytest.raises(NotImplementedError, match="reanalyze"):
        SampledUniZeroPolicy(c, device="cpu")
