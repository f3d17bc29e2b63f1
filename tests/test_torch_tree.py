"""Port vs JAX: the batched search tree (lightzero_tpu_torch/search/tree.py
against lightzero_tpu/search/tree.py): init_tree, minmax_normalize and the
root read-outs on the same numpy-seeded tree statistics. Exact where the
result is an integer or a copy; 1e-6 where it divides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.search import tree as jax_tree
from lightzero_tpu_torch.search import tree

pytestmark = pytest.mark.unittest

B, N, A = 5, 9, 3


def _pair(rng):
    """The same random tree statistics as a JAX Tree and a port Tree."""
    children = -np.ones((B, N, A), np.int32)
    for b in range(B):
        for k in range(1, N):
            if rng.random() < 0.8:
                p = int(rng.integers(0, k))
                free = np.flatnonzero(children[b, p] < 0)
                if free.size:
                    children[b, p, rng.choice(free)] = k
    visits = rng.integers(0, 6, (B, N)).astype(np.int32)
    vsum = rng.standard_normal((B, N)).astype(np.float32)
    reward = rng.standard_normal((B, N)).astype(np.float32)
    vmin = rng.standard_normal(B).astype(np.float32)
    vmax = (vmin + rng.uniform(-0.5, 2.0, B)).astype(np.float32)
    emb = np.zeros((B, 4), np.float32)
    jt = jax_tree.init_tree(B, N, A, jnp.asarray(emb))._replace(
        children=jnp.asarray(children), visit_count=jnp.asarray(visits),
        value_sum=jnp.asarray(vsum), reward=jnp.asarray(reward),
        vmin=jnp.asarray(vmin), vmax=jnp.asarray(vmax),
    )
    pt = tree.init_tree(B, N, A, torch.from_numpy(emb))._replace(
        children=torch.from_numpy(children), visit_count=torch.from_numpy(visits),
        value_sum=torch.from_numpy(vsum), reward=torch.from_numpy(reward),
        vmin=torch.from_numpy(vmin), vmax=torch.from_numpy(vmax),
    )
    return jt, pt


def test_init_tree_matches():
    emb = {"latent": np.zeros((B, 6), np.float32)}
    jt = jax_tree.init_tree(B, N, A, {"latent": jnp.asarray(emb["latent"])})
    pt = tree.init_tree(B, N, A, {"latent": torch.from_numpy(emb["latent"])})
    for field in ("visit_count", "value_sum", "reward", "raw_value", "prior", "children",
                  "to_play", "terminal", "is_chance", "legal", "vmin", "vmax"):
        exp = np.asarray(getattr(jt, field))
        got = getattr(pt, field).numpy()
        assert got.dtype == exp.dtype, field
        np.testing.assert_array_equal(got, exp, err_msg=field)
    assert pt.embedding["latent"].shape == jt.embedding["latent"].shape


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_root_readouts_match(seed):
    jt, pt = _pair(np.random.default_rng(seed))
    np.testing.assert_array_equal(
        tree.root_visit_counts(pt).numpy(), np.asarray(jax_tree.root_visit_counts(jt))
    )
    np.testing.assert_allclose(
        tree.root_value(pt).numpy(), np.asarray(jax_tree.root_value(jt)), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        tree.root_children_values(pt, 0.997).numpy(),
        np.asarray(jax_tree.root_children_values(jt, 0.997)), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        pt.node_value().numpy(), np.asarray(jt.node_value()), rtol=1e-6, atol=1e-6
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_minmax_normalize_matches(seed):
    jt, pt = _pair(np.random.default_rng(seed))
    q = np.random.default_rng(seed + 10).standard_normal((B, A)).astype(np.float32)
    exp = jax_tree.minmax_normalize(jt.vmin, jt.vmax, 0.01, jnp.asarray(q))
    got = tree.minmax_normalize(pt.vmin, pt.vmax, 0.01, torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6, atol=1e-6)
