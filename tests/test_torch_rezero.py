"""Port vs JAX: ReZero's reuse search and whole-buffer reanalyze
(lightzero_tpu_torch/search/puct.py, policy/muzero.py:forward_reanalyze and
buffers/game_buffer.py:reanalyze_buffer against their counterparts in
lightzero_tpu/), and train_rezero on the CPU.

Tolerances: visit counts, chosen actions, descent states and tree structure
exact; root values and values backed up into trees 1e-4 relative with a
1e-4 floor (float32 sums in another order, through the inverse value
transform for the model's values; ROADMAP queue 3).

- the reuse search (``true_action``, ``reuse_value``) on the fake model of
  tests/test_rezero_reuse.py, its all-legal case (B=4, A=5, 30 simulations)
  and its masked-legal case (B=2, A=7, 35 simulations), in float32;
- both reuse stops, descent and backup against JAX's ``_traverse`` and
  ``_expand_and_backup`` on the same trees: the root picks the true action
  whose child is missing (expanded, the reused value backed up) and whose
  child exists (re-used without expansion, like a terminal stop);
- a high reused value draws over 80 % of the root visits to the true action;
- ``forward_reanalyze`` with reuse on imported weights, with JAX's own
  Dirichlet draw injected and tie_break='first';
- ``reanalyze_buffer`` plain and with reuse on the same episodes and
  weights (reanalyze_noise off, tie_break='first'): the same policy targets,
  root values and count, and the next sample serves the fresh targets;
- a small-width train_rezero run logs each round's reanalyze, with the
  count of the newest episodes that cover 75 % of the buffer.
"""
import dataclasses
import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.buffers.game_buffer import EpisodeRecord as JaxEpisodeRecord
from lightzero_tpu.buffers.game_buffer import GameBuffer as JaxGameBuffer
from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.policy.muzero import MuZeroPolicy as JaxMuZeroPolicy
from lightzero_tpu.search import batch_puct_search as jax_search
from lightzero_tpu.search import puct as jax_puct
from lightzero_tpu.search.tree import Tree as JaxTree
from lightzero_tpu.search.types import RecurrentOutput as JaxRecurrentOutput
from lightzero_tpu.search.types import RootOutput as JaxRootOutput
from lightzero_tpu.search.types import SearchConfig as JaxSearchConfig
from lightzero_tpu_torch.buffers import EpisodeRecord, GameBuffer
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import train_rezero
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.search import RecurrentOutput, RootOutput, SearchConfig, batch_puct_search
from lightzero_tpu_torch.search import puct
from lightzero_tpu_torch.search.tree import Tree, init_tree, map_embedding
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from test_torch_buffer import random_episodes
from test_torch_learn import SMALL
from test_torch_model import perturbed_params

pytestmark = pytest.mark.unittest

VALUE_RTOL = VALUE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _values_close(got, exp):
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp), rtol=VALUE_RTOL, atol=VALUE_ATOL)


# ------------------------------------------------------------ the fake model
# tests/test_rezero_reuse.py's deterministic model, on a (B,) latent


def _jax_fake(A):
    def recurrent_fn(params, rng, action, embedding):
        nl = jnp.tanh(embedding["latent"] * 1.3 + (action + 1) * 0.37)
        return JaxRecurrentOutput(
            reward=jnp.sin(nl * 3.0) * 0.5, value=jnp.cos(nl * 2.0) * 0.5,
            prior_logits=jnp.stack([jnp.sin(nl * (a + 1) * 1.7) for a in range(A)], -1) * 2.0,
            embedding={"latent": nl},
        )
    return recurrent_fn


def _torch_fake(A):
    def recurrent_fn(action, embedding):
        nl = torch.tanh(embedding["latent"] * 1.3 + (action + 1) * 0.37)
        return RecurrentOutput(
            reward=torch.sin(nl * 3.0) * 0.5, value=torch.cos(nl * 2.0) * 0.5,
            prior_logits=torch.stack([torch.sin(nl * (a + 1) * 1.7) for a in range(A)], -1) * 2.0,
            embedding={"latent": nl},
        )
    return recurrent_fn


def _fake_root(obs, A):
    latent = np.asarray(obs, np.float32)
    logits = (np.stack([np.sin(latent * (a + 1) * 1.7) for a in range(A)], -1) * 2.0)
    value = np.cos(latent * 2.0) * 0.5
    return latent, logits.astype(np.float32), value.astype(np.float32)


def _legal(legal_lists, A):
    legal = np.zeros((len(legal_lists), A), bool)
    for i, la in enumerate(legal_lists):
        legal[i, la] = True
    return legal


CASES = {
    # tests/test_rezero_reuse.py:test_reuse_single_player_golden
    "all_legal": dict(obs=[0.1, 0.5, -0.3, 0.9], A=5, sims=30, legal=[list(range(5))] * 4,
                      true_action=[0, 2, 4, 1], reuse_value=[0.8, -0.4, 0.1, 1.5]),
    # tests/test_rezero_reuse.py:test_reuse_masked_legal_golden
    "masked_legal": dict(obs=[0.4, -0.6], A=7, sims=35, legal=[[0, 2, 4], [1, 3, 5, 6]],
                         true_action=[2, 6], reuse_value=[2.0, -1.0]),
}


def _reuse_searches(case, discount=0.997):
    A, sims = case["A"], case["sims"]
    latent, logits, value = _fake_root(case["obs"], A)
    legal = _legal(case["legal"], A)
    B = len(latent)
    ta = np.asarray(case["true_action"])
    rv = np.asarray(case["reuse_value"], np.float32)
    jroot = JaxRootOutput(prior_logits=jnp.asarray(logits), value=jnp.asarray(value),
                          embedding={"latent": jnp.asarray(latent)})
    exp = jax_search(None, jax.random.PRNGKey(0), jroot, _jax_fake(A),
                     JaxSearchConfig(num_simulations=sims, discount=discount, tie_break="first"),
                     jnp.asarray(legal), to_play=jnp.full((B,), -1, jnp.int32), with_noise=False,
                     true_action=jnp.asarray(ta, jnp.int32), reuse_value=jnp.asarray(rv))
    root = RootOutput(prior_logits=torch.from_numpy(logits), value=torch.from_numpy(value),
                      embedding={"latent": torch.from_numpy(latent)})
    got = batch_puct_search(root, _torch_fake(A),
                            SearchConfig(num_simulations=sims, discount=discount, tie_break="first"),
                            torch.from_numpy(legal), with_noise=False,
                            true_action=torch.from_numpy(ta), reuse_value=torch.from_numpy(rv),
                            device="cpu")
    return exp, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_reuse_search_matches_jax(case):
    exp, got = _reuse_searches(CASES[case])
    np.testing.assert_array_equal(got.visit_counts.numpy(), np.asarray(exp.visit_counts))
    np.testing.assert_array_equal(got.tree.children.numpy(), np.asarray(exp.tree.children))
    np.testing.assert_array_equal(got.tree.visit_count.numpy(), np.asarray(exp.tree.visit_count))
    _values_close(got.root_value, exp.root_value)
    _values_close(got.tree.value_sum, exp.tree.value_sum)
    legal = _legal(CASES[case]["legal"], CASES[case]["A"])
    assert not got.visit_counts.numpy()[~legal].any()


def test_reuse_routes_to_the_generic_descent(monkeypatch):
    """Only the generic descent knows true_action: a reuse search must not
    reach fused_traverse (the JAX package routes it the same way,
    puct.py:372-378), and a plain search still does."""
    calls, original = [], puct.fused_traverse

    def counting(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(puct, "fused_traverse", counting)
    _reuse_searches(CASES["masked_legal"])
    assert calls == []
    case = CASES["masked_legal"]
    latent, logits, value = _fake_root(case["obs"], case["A"])
    root = RootOutput(prior_logits=torch.from_numpy(logits), value=torch.from_numpy(value),
                      embedding={"latent": torch.from_numpy(latent)})
    batch_puct_search(root, _torch_fake(case["A"]), SearchConfig(num_simulations=3),
                      torch.from_numpy(_legal(case["legal"], case["A"])), with_noise=False,
                      device="cpu")
    assert len(calls) == 3


def _as_jax_tree(tree: Tree) -> JaxTree:
    """Copies: the port's search updates its tree tensors in place."""
    return JaxTree(**{name: jnp.array(getattr(tree, name).numpy().copy())
                      for name in Tree._fields if name != "embedding"},
                   embedding={"latent": jnp.array(tree.embedding["latent"].numpy().copy())})


def _check_tree(tree: Tree, jtree: JaxTree):
    for name in ("children", "visit_count", "legal", "to_play"):
        np.testing.assert_array_equal(getattr(tree, name).numpy(), np.asarray(getattr(jtree, name)),
                                      err_msg=name)
    for name in ("value_sum", "reward", "prior", "vmin", "vmax"):
        _values_close(getattr(tree, name), getattr(jtree, name))


def test_both_reuse_stops_match_jax():
    """Seven simulations of a reuse search, each descent and backup held
    against JAX's on the same tree. Trees 0 and 1 have a high reused value:
    the root picks the true action while its child is missing (expanded,
    the reused value backed up instead of the model's) and, once every root
    arm is visited, while the child exists (re-used without expansion, its
    parent the root). Trees 2 and 3 have a low one."""
    A, B, N = 3, 4, 8
    latent, logits, value = _fake_root([0.2, -0.7, 0.45, 0.9], A)
    ta = np.asarray([2, 0, 2, 1])
    rv = np.asarray([50.0, 40.0, -3.0, -2.5], np.float32)
    cfg = SearchConfig(num_simulations=N - 1, tie_break="first")
    jcfg = JaxSearchConfig(num_simulations=N - 1, tie_break="first")
    legal = torch.ones((B, A), dtype=torch.bool)
    to_play = torch.full((B,), -1, dtype=torch.int32)
    root = RootOutput(prior_logits=torch.from_numpy(logits), value=torch.from_numpy(value),
                      embedding={"latent": torch.from_numpy(latent)})
    tree = init_tree(B, N, A, root.embedding, device="cpu")
    tree = puct.prepare_roots(cfg, tree, root, legal, to_play, with_noise=False)
    jtree = _as_jax_tree(tree)
    true_action, reuse_value = torch.from_numpy(ta), torch.from_numpy(rv)
    bidx = torch.arange(B)
    seen = {"missing": 0, "existing": 0}
    for sim in range(N - 1):
        st = puct._traverse(cfg, tree, to_play, None, None, true_action, reuse_value)
        jst, jparent = jax_puct._traverse(jcfg, jtree, jax.random.PRNGKey(sim),
                                          jnp.asarray(to_play.numpy()),
                                          jnp.asarray(ta, jnp.int32), jnp.asarray(rv))
        for name, g, e in (("node", st.node, jst.node), ("depth", st.depth, jst.depth),
                           ("parent", st.parent, jparent),
                           ("last_action", st.last_action, jst.last_action),
                           ("leaf_is_terminal_node", st.leaf_is_terminal_node,
                            jst.leaf_is_terminal_node),
                           ("reuse_hit", st.reuse_hit, jst.reuse_hit),
                           ("path", st.path, jst.path), ("path_visit", st.path_visit,
                                                         jst.path_visit)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=f"{name} {sim}")
        hit, term = st.reuse_hit.numpy(), st.leaf_is_terminal_node.numpy()
        np.testing.assert_array_equal(st.last_action.numpy()[hit], ta[hit])
        missing, existing = hit & ~term, hit & term
        true_child = tree.children[bidx, 0, true_action].numpy()
        np.testing.assert_array_equal(st.depth.numpy()[missing], 0)
        np.testing.assert_array_equal(st.depth.numpy()[existing], 1)
        np.testing.assert_array_equal(st.parent.numpy()[existing], 0)
        np.testing.assert_array_equal(st.node.numpy()[existing], true_child[existing])
        out = _torch_fake(A)(st.last_action, map_embedding(lambda e: e[bidx, st.parent],
                                                             tree.embedding))
        children_before = tree.children.clone()
        visits_before, vsum_before = tree.visit_count.clone(), tree.value_sum.clone()
        tree = puct._expand_and_backup(cfg, tree, st, sim, out, value_override=reuse_value)
        jout = _jax_fake(A)(None, None, jst.last_action,
                            {"latent": jtree.embedding["latent"][jnp.arange(B), jparent]})
        jtree = jax_puct._expand_and_backup(jcfg, jtree, jst._replace(parent=jparent),
                                            jnp.int32(sim), jout, value_override=jnp.asarray(rv))
        _check_tree(tree, jtree)
        vsum = tree.value_sum.numpy()
        # a missing true child is expanded with the reused value, not the model's
        np.testing.assert_allclose(vsum[missing, sim + 1], rv[missing], rtol=1e-6)
        fresh = ~existing & ~missing
        np.testing.assert_allclose(vsum[fresh, sim + 1], out.value.numpy()[fresh], rtol=1e-6)
        # an existing one takes another visit and the reused value; nothing new
        rows = np.flatnonzero(existing)
        assert torch.equal(tree.children[rows], children_before[rows])
        assert not tree.visit_count[rows, sim + 1].any()
        c = true_child[rows]
        np.testing.assert_array_equal(tree.visit_count.numpy()[rows, c],
                                      visits_before.numpy()[rows, c] + 1)
        np.testing.assert_allclose(vsum[rows, c], vsum_before.numpy()[rows, c] + rv[rows],
                                   rtol=1e-6)
        seen["missing"] += int(missing.sum())
        seen["existing"] += int(existing.sum())
    assert seen["missing"] > 0 and seen["existing"] > 0, seen


def test_a_high_reused_value_draws_most_visits():
    """tests/test_rezero_reuse.py:test_reuse_high_value_attracts_visits on the
    port, and the same visit counts as the JAX search."""
    B, A, S = 4, 4, 40

    def torch_fn(action, embedding):
        nl = torch.tanh(embedding["latent"] * 1.3 + (action + 1) * 0.37)
        return RecurrentOutput(reward=torch.zeros_like(nl), value=torch.zeros_like(nl),
                               prior_logits=torch.zeros(nl.shape + (A,)), embedding={"latent": nl})

    def jax_fn(params, rng, action, embedding):
        nl = jnp.tanh(embedding["latent"] * 1.3 + (action + 1) * 0.37)
        return JaxRecurrentOutput(reward=jnp.zeros_like(nl), value=jnp.zeros_like(nl),
                                  prior_logits=jnp.zeros(nl.shape + (A,)), embedding={"latent": nl})

    latent = np.linspace(-1, 1, B).astype(np.float32)
    got = batch_puct_search(
        RootOutput(prior_logits=torch.zeros(B, A), value=torch.zeros(B),
                   embedding={"latent": torch.from_numpy(latent)}),
        torch_fn, SearchConfig(num_simulations=S, tie_break="first"),
        torch.ones((B, A), dtype=torch.bool), with_noise=False,
        true_action=torch.full((B,), 2), reuse_value=torch.full((B,), 50.0), device="cpu")
    counts = got.visit_counts.numpy()
    assert (counts[:, 2] > S * 0.8).all(), counts
    exp = jax_search(None, jax.random.PRNGKey(0),
                     JaxRootOutput(prior_logits=jnp.zeros((B, A)), value=jnp.zeros((B,)),
                                   embedding={"latent": jnp.asarray(latent)}),
                     jax_fn, JaxSearchConfig(num_simulations=S, tie_break="first"),
                     jnp.ones((B, A), bool), with_noise=False,
                     true_action=jnp.full((B,), 2, jnp.int32), reuse_value=jnp.full((B,), 50.0))
    np.testing.assert_array_equal(counts, np.asarray(exp.visit_counts))


# ------------------------------------------------------- policy and buffer


@pytest.fixture(scope="module")
def policies():
    """The JAX and the port MuZero policy on the same perturbed flax params
    (latent 32, support scale 10, 5 simulations), tie_break='first'."""
    cfg = jax_deep_merge(JaxMuZeroPolicy.default_config(), SMALL)
    jax_policy = JaxMuZeroPolicy(cfg)
    jax_policy.search_cfg = dataclasses.replace(jax_policy.search_cfg, tie_break="first")
    params = jax.tree_util.tree_map(jnp.asarray, perturbed_params(jax_policy.model, 6))
    port = MuZeroPolicy(SMALL, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    port.search_cfg = dataclasses.replace(port.search_cfg, tie_break="first")
    return jax_policy, params, port


def test_forward_reanalyze_with_reuse_matches_jax(policies):
    jax_policy, params, port = policies
    rng = np.random.default_rng(11)
    B, A = 6, 2
    obs = rng.standard_normal((B, 4)).astype(np.float32)
    legal = np.ones((B, A), bool)
    ta = rng.integers(0, A, B)
    rv = rng.uniform(-3, 3, B).astype(np.float32)
    key = jax.random.PRNGKey(5)
    exp_policy, exp_values = jax_policy.forward_reanalyze(
        params, key, jnp.asarray(obs), jnp.asarray(legal), true_action=jnp.asarray(ta, jnp.int32),
        reuse_value=jnp.asarray(rv))
    # JAX's root noise: the search splits its key once and draws Gamma(alpha)
    # with the second half (puct.py:785-786, 733-737)
    _, prep = jax.random.split(key)
    g = np.asarray(jax.random.gamma(prep, float(jax_policy.cfg.root_dirichlet_alpha), (B, A),
                                    jnp.float32))
    noise = torch.from_numpy(g / g.sum(-1, keepdims=True))
    got_policy, got_values = port.forward_reanalyze(
        port.model, torch.from_numpy(obs), torch.from_numpy(legal),
        true_action=torch.from_numpy(ta), reuse_value=torch.from_numpy(rv), noise=noise)
    np.testing.assert_array_equal(got_policy.numpy(), np.asarray(exp_policy))
    _values_close(got_values, exp_values)
    # the same search without reuse answers otherwise
    plain, _ = port.forward_reanalyze(port.model, torch.from_numpy(obs), torch.from_numpy(legal),
                                      noise=noise)
    assert not torch.equal(plain, got_policy)


def _buffers(policies, **cfg):
    jax_policy, _, port = policies
    cfg = dict(SMALL, seed=3, batch_size=16, reanalyze_noise=False, **cfg)
    jax_policy = JaxMuZeroPolicy(jax_deep_merge(jax_policy.cfg, cfg))
    jax_policy.search_cfg = dataclasses.replace(jax_policy.search_cfg, tie_break="first")
    port_policy = MuZeroPolicy(jax_deep_merge(port.cfg, cfg), model=port.model, device="cpu")
    port_policy.search_cfg = port.search_cfg
    jax_buf = JaxGameBuffer(jax_policy.cfg, jax_policy)
    buf = GameBuffer(port_policy.cfg, port_policy)
    episodes, priorities = random_episodes(5)
    jax_buf.push_episodes([JaxEpisodeRecord(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                                               for k, v in e.items()}) for e in episodes],
                          priorities)
    buf.push_episodes([EpisodeRecord(**e) for e in episodes], priorities)
    return jax_buf, buf


def newest_covering(lengths, partition):
    """Transitions of the newest episodes that cover ``partition`` of the
    stored ones, as reanalyze_buffer picks them."""
    budget, covered = int(sum(lengths) * partition), 0
    for T in reversed(lengths):
        covered += T
        if covered >= budget:
            break
    return covered


@pytest.mark.parametrize("reuse", [False, True], ids=["plain", "reuse"])
def test_reanalyze_buffer_matches_jax(policies, reuse):
    _, params, port = policies
    jax_buf, buf = _buffers(policies)
    before = [ep.child_visits.copy() for ep in buf._episodes]
    buf.sample(16, port.model)  # the flat pool is built: reanalyze must mark it stale
    jax_buf.sample(16, params)
    exp_n = jax_buf.reanalyze_buffer(params, jax.random.PRNGKey(2), reanalyze_batch_size=3,
                                     partition=0.75, reuse_search=reuse)
    n = buf.reanalyze_buffer(port.model, reanalyze_batch_size=3, partition=0.75,
                             reuse_search=reuse)
    assert n == exp_n == newest_covering([len(ep.actions) for ep in buf._episodes], 0.75)
    changed = 0
    for e, (ep, jep) in enumerate(zip(buf._episodes, jax_buf._episodes)):
        np.testing.assert_array_equal(ep.child_visits, jep.child_visits, err_msg=str(e))
        _values_close(ep.root_values, jep.root_values)
        changed += int((ep.child_visits != before[e]).any(-1).sum())
    assert changed > n // 2  # searched visit counts replaced the random targets
    # the next sample serves the fresh targets on the native path
    got, idx = buf.sample(16, port.model)
    exp, exp_idx = jax_buf.sample(16, params)
    np.testing.assert_array_equal(idx, exp_idx)
    np.testing.assert_allclose(got.target_policy.numpy(), np.asarray(exp.target_policy),
                               rtol=1e-6, atol=1e-6)


def test_train_rezero_logs_the_reanalyze_on_the_cpu(tmp_path):
    model = dict(SMALL["model"])
    cfg = Config(dict(
        exp_name=str(tmp_path / "exp"),
        env=dict(type="cartpole", stop_value=10_000, collector_env_num=2, evaluator_env_num=2),
        policy=dict(model=model, num_simulations=5, batch_size=16, update_per_collect=4,
                    n_episode=2, eval_freq=1000, ssl_loss_weight=2.0,
                    buffer_reanalyze_freq=1.0, reanalyze_batch_size=4,
                    reanalyze_partition=0.75, reuse_search=True),
    ))
    policy, state, stats = train_rezero(cfg, seed=0, max_env_step=200, device="cpu")
    assert stats["env_steps"] == 256 and stats["train_iter"] == 8
    log = (tmp_path / "exp" / "log" / "train.txt").read_text()
    logged = [int(n) for n in re.findall(r"rezero: reanalyzed (\d+) transitions", log)]
    with open(tmp_path / "exp" / "log" / "train.jsonl") as f:
        sizes = [int(r["collector/buffer_transitions"]) for r in map(json.loads, f)
                 if "collector/buffer_transitions" in r]
    lengths = [len(ep.actions) for ep in stats["buffer"]._episodes]
    cum = np.cumsum(lengths)
    # the buffer as each reanalyze saw it: the episodes pushed by then
    expected = [newest_covering(lengths[:int(np.searchsorted(cum, s)) + 1], 0.75) for s in sizes]
    assert logged == expected and len(logged) == 2


def test_rezero_config_is_the_zoo_config():
    from lightzero_tpu_torch.configs.cartpole_rezero_mz import main_config
    from zoo.classic_control.cartpole.config.cartpole_rezero_mz_config import (
        main_config as zoo_config,
    )

    assert main_config.to_dict() == JaxConfig(zoo_config).to_dict()
