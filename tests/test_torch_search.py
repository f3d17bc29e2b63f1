"""Port vs JAX: the batched pUCT search (lightzero_tpu_torch/search/puct.py
against lightzero_tpu/search/puct.py, with use_pallas_traverse off and on)
with the dummy recurrent fn of tests/test_pallas_traverse.py ported to
torch, tie_break='first' and the same injected Dirichlet noise.

Visit counts must be exactly equal. Root values and children values agree to
1e-5: the two recurrent fns round tanh/cos differently in the last bit, and
the backup composes the discounted sums in another order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.search import batch_puct_search as jax_search
from lightzero_tpu.search.types import RecurrentOutput as JaxRecurrentOutput
from lightzero_tpu.search.types import RootOutput as JaxRootOutput
from lightzero_tpu.search.types import SearchConfig as JaxSearchConfig
from lightzero_tpu_torch.search import (
    RecurrentOutput,
    RootOutput,
    SearchConfig,
    batch_puct_search,
)
from lightzero_tpu_torch.search.puct import _pack_traverse_tables

pytestmark = pytest.mark.unittest

B, A = 8, 5


def _jax_dummy_recurrent(params, rng, action, embedding):
    latent = embedding["latent"]
    a = action.astype(jnp.float32)[:, None]
    new_latent = jnp.tanh(latent * 0.9 + a * 0.13 + 0.05)
    value = jnp.tanh(new_latent.sum(axis=-1))
    reward = 0.1 * jnp.cos(new_latent.mean(axis=-1) * 3.0)
    prior = jnp.sin(new_latent @ jnp.arange(1.0, 5.0)[:, None] * jnp.arange(1.0, A + 1.0)[None, :])
    return JaxRecurrentOutput(
        prior_logits=prior, value=value, reward=reward, embedding={"latent": new_latent}
    )


def _torch_dummy_recurrent(action, embedding):
    latent = embedding["latent"]
    a = action.to(torch.float32)[:, None]
    new_latent = torch.tanh(latent * 0.9 + a * 0.13 + 0.05)
    value = torch.tanh(new_latent.sum(dim=-1))
    reward = 0.1 * torch.cos(new_latent.mean(dim=-1) * 3.0)
    prior = torch.sin(
        new_latent @ torch.arange(1.0, 5.0)[:, None] * torch.arange(1.0, A + 1.0)[None, :]
    )
    return RecurrentOutput(
        prior_logits=prior, value=value, reward=reward, embedding={"latent": new_latent}
    )


def _inputs(seed):
    rng = np.random.default_rng(seed)
    legal = np.ones((B, A), bool)
    legal[0, 3] = legal[2, 0] = legal[5, 1:3] = False
    noise = rng.dirichlet(np.full(A, 0.3), B).astype(np.float32)
    noise = np.where(legal, noise, 0.0).astype(np.float32)
    return dict(
        prior_logits=rng.standard_normal((B, A)).astype(np.float32),
        value=rng.uniform(-1.0, 1.0, B).astype(np.float32),
        latent=rng.standard_normal((B, 4)).astype(np.float32),
        legal=legal,
        noise=noise,
    )


def _run_jax(d, sims, use_pallas):
    cfg = JaxSearchConfig(num_simulations=sims, tie_break="first",
                          use_pallas_traverse=use_pallas)
    root = JaxRootOutput(
        prior_logits=jnp.asarray(d["prior_logits"]), value=jnp.asarray(d["value"]),
        embedding={"latent": jnp.asarray(d["latent"])},
    )
    return jax_search(
        None, jax.random.PRNGKey(0), root, _jax_dummy_recurrent, cfg,
        jnp.asarray(d["legal"]), to_play=jnp.full((B,), -1, jnp.int32),
        noise=jnp.asarray(d["noise"]),
    )


def _run_port(d, sims):
    cfg = SearchConfig(num_simulations=sims, tie_break="first")
    root = RootOutput(
        prior_logits=torch.from_numpy(d["prior_logits"]), value=torch.from_numpy(d["value"]),
        embedding={"latent": torch.from_numpy(d["latent"])},
    )
    return batch_puct_search(
        root, _torch_dummy_recurrent, cfg, torch.from_numpy(d["legal"]),
        noise=torch.from_numpy(d["noise"]), device="cpu",
    )


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("seed,sims", [(0, 12), (1, 30)])
def test_search_matches_jax(use_pallas, seed, sims):
    d = _inputs(seed)
    exp = _run_jax(d, sims, use_pallas)
    got = _run_port(d, sims)
    np.testing.assert_array_equal(got.visit_counts.numpy(), np.asarray(exp.visit_counts))
    np.testing.assert_allclose(got.root_value.numpy(), np.asarray(exp.root_value),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.root_children_values.numpy(),
                               np.asarray(exp.root_children_values), rtol=1e-5, atol=1e-5)
    # the whole tree: structure exactly, statistics to the same tolerance
    np.testing.assert_array_equal(got.tree.children.numpy(), np.asarray(exp.tree.children))
    np.testing.assert_array_equal(got.tree.visit_count.numpy(), np.asarray(exp.tree.visit_count))
    np.testing.assert_allclose(got.tree.value_sum.numpy(), np.asarray(exp.tree.value_sum),
                               rtol=1e-5, atol=1e-5)
    for name in ("vmin", "vmax"):
        np.testing.assert_allclose(getattr(got.tree, name).numpy(),
                                   np.asarray(getattr(exp.tree, name)), rtol=1e-5, atol=1e-5)


def test_pack_traverse_tables_matches_jax():
    from lightzero_tpu.search.puct import _pack_traverse_tables as jax_pack

    exp_out = _run_jax(_inputs(2), 9, False)
    got_out = _run_port(_inputs(2), 9)
    exp = np.asarray(jax_pack(exp_out.tree))
    got = _pack_traverse_tables(got_out.tree).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., :A], exp[..., :A])  # child links


def test_noise_tie_break_search_runs_and_counts_every_simulation():
    d = _inputs(3)
    cfg = SearchConfig(num_simulations=10, tie_break="noise")
    root = RootOutput(
        prior_logits=torch.zeros(B, A), value=torch.zeros(B),
        embedding={"latent": torch.from_numpy(d["latent"])},
    )
    out = batch_puct_search(root, _torch_dummy_recurrent, cfg, torch.from_numpy(d["legal"]),
                            generator=torch.Generator().manual_seed(0), device="cpu")
    assert out.visit_counts.sum(dim=1).tolist() == [10] * B
    assert not out.visit_counts[~torch.from_numpy(d["legal"])].any()


# a stochastic search with players == 2 was refused until slice 17's second
# half; it now runs (held against JAX in tests/test_torch_board_gumbel.py)
@pytest.mark.parametrize(
    "change,kwargs,error",
    [
        (dict(stochastic=True, players=2), {}, None),
        ({}, dict(true_action=np.zeros(B, np.int64)), ValueError),
    ],
    ids=["stochastic_players_2", "reuse_without_value"],
)
def test_out_of_scope_searches_raise(change, kwargs, error):
    d = _inputs(4)
    cfg = dataclasses.replace(SearchConfig(num_simulations=4, tie_break="first"), **change)
    root = RootOutput(
        prior_logits=torch.from_numpy(d["prior_logits"]), value=torch.from_numpy(d["value"]),
        embedding={"latent": torch.from_numpy(d["latent"])},
    )
    kwargs = {k: torch.from_numpy(v) for k, v in kwargs.items()}
    if error is not None:
        with pytest.raises(error, match="reuse search takes both"):
            batch_puct_search(root, _torch_dummy_recurrent, cfg, torch.from_numpy(d["legal"]),
                              device="cpu", **kwargs)
        return
    out = batch_puct_search(root, _torch_dummy_recurrent, cfg, torch.from_numpy(d["legal"]),
                            to_play=torch.tensor([1, 2] * (B // 2), dtype=torch.int32),
                            generator=torch.Generator().manual_seed(0), device="cpu", **kwargs)
    assert out.visit_counts.sum(dim=1).tolist() == [4] * B


# the two players-2 searches that test_out_of_scope_searches_raise refused
# until two-player search was ported, now held against JAX (the golden cases
# are in tests/test_torch_two_player_search.py)
@pytest.mark.parametrize("reuse", [False, True], ids=["plain", "reuse"])
def test_two_player_searches_match_jax(reuse):
    d = _inputs(4)
    to_play = np.array([1, 2, 1, -1, 2, 1, 2, -1], np.int32)
    kw = {}
    if reuse:
        kw = dict(true_action=np.array([0, 1, 1, 2, 4, 0, 3, 1]),
                  reuse_value=np.linspace(-0.6, 0.6, B).astype(np.float32))
    cfg = JaxSearchConfig(num_simulations=10, tie_break="first", players=2)
    root = JaxRootOutput(prior_logits=jnp.asarray(d["prior_logits"]), value=jnp.asarray(d["value"]),
                         embedding={"latent": jnp.asarray(d["latent"])})
    exp = jax_search(None, jax.random.PRNGKey(0), root, _jax_dummy_recurrent, cfg,
                     jnp.asarray(d["legal"]), to_play=jnp.asarray(to_play),
                     noise=jnp.asarray(d["noise"]), **{k: jnp.asarray(v) for k, v in kw.items()})
    root = RootOutput(prior_logits=torch.from_numpy(d["prior_logits"]),
                      value=torch.from_numpy(d["value"]),
                      embedding={"latent": torch.from_numpy(d["latent"])})
    got = batch_puct_search(root, _torch_dummy_recurrent,
                            SearchConfig(num_simulations=10, tie_break="first", players=2),
                            torch.from_numpy(d["legal"]), to_play=torch.from_numpy(to_play),
                            noise=torch.from_numpy(d["noise"]), device="cpu",
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got.visit_counts.numpy(), np.asarray(exp.visit_counts))
    np.testing.assert_allclose(got.root_value.numpy(), np.asarray(exp.root_value),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.tree.to_play.numpy(), np.asarray(exp.tree.to_play))
