"""Array-based batched search tree (``lightzero_tpu/search/tree.py``).

Node ``i`` is the node expanded by simulation ``i`` (node 0 = root), so
``num_nodes = num_simulations + 1`` and every tensor has a fixed shape.
The search updates these tensors in place (the JAX tree is rebuilt
functionally each simulation); nothing else holds a reference to them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

UNVISITED = -1


def map_embedding(fn: Callable, emb: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over an embedding that is a tensor, a dict of
    tensors or a NamedTuple of tensors (an env state, AlphaZero's embedding):
    the port's stand-in for a JAX pytree."""
    if isinstance(emb, dict):
        return {k: map_embedding(fn, v, *(r[k] for r in rest)) for k, v in emb.items()}
    if isinstance(emb, tuple):
        return type(emb)(*(map_embedding(fn, v, *(r[i] for r in rest))
                           for i, v in enumerate(emb)))
    return fn(emb, *rest)


class Tree(NamedTuple):
    """A batch of B independent trees with N = num_simulations + 1 nodes."""

    visit_count: torch.Tensor  # (B, N) int32
    value_sum: torch.Tensor  # (B, N) f32
    reward: torch.Tensor  # (B, N) f32
    raw_value: torch.Tensor  # (B, N) f32 network value at expansion
    prior: torch.Tensor  # (B, N, A) f32 children priors
    children: torch.Tensor  # (B, N, A) int32 child node index, -1 = virtual
    to_play: torch.Tensor  # (B, N) int32 player at node (-1 = 1p mode)
    terminal: torch.Tensor  # (B, N) bool absorbing state
    is_chance: torch.Tensor  # (B, N) bool chance (afterstate) node, Stochastic MuZero
    legal: torch.Tensor  # (B, N, A) bool legal child actions
    embedding: Any  # tensor or dict of (B, N, ...) per-node latents
    vmin: torch.Tensor  # (B,) per-tree MinMax stats
    vmax: torch.Tensor  # (B,)

    @property
    def num_trees(self) -> int:
        return self.visit_count.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.visit_count.shape[1]

    @property
    def num_actions(self) -> int:
        return self.prior.shape[2]

    def node_value(self) -> torch.Tensor:
        """(B, N) mean value; 0 for unvisited nodes."""
        return torch.where(
            self.visit_count > 0,
            self.value_sum / torch.clamp(self.visit_count, min=1).to(self.value_sum.dtype),
            0.0,
        )


def minmax_normalize(
    vmin: torch.Tensor, vmax: torch.Tensor, value_delta_max: float, q: torch.Tensor
) -> torch.Tensor:
    """Normalize q by per-tree (min, max) as the reference MinMaxStats does
    (minimax.py:54-70): only when delta > 0; divide by max(delta,
    value_delta_max)."""
    extra = (1,) * (q.dim() - 1)
    delta = (vmax - vmin).reshape(vmin.shape[0], *extra)
    vmin_b = vmin.reshape(vmin.shape[0], *extra)
    denom = torch.clamp(delta, min=value_delta_max)
    return torch.where(delta > 0, (q - vmin_b) / denom, q)


def init_tree(
    batch_size: int,
    num_nodes: int,
    num_actions: int,
    embedding_example: Any,
    dtype: torch.dtype = torch.float32,
    device: torch.device = torch.device("cpu"),
) -> Tree:
    """Allocate an empty batch of trees. ``embedding_example`` is a tensor (or
    dict of tensors) of shape (B, ...) giving the per-node latent shapes."""
    B, N, A = batch_size, num_nodes, num_actions

    def alloc_embedding(x):
        return torch.zeros((B, N) + tuple(x.shape[1:]), dtype=x.dtype, device=device)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return Tree(
        visit_count=zeros(B, N, dt=torch.int32),
        value_sum=zeros(B, N),
        reward=zeros(B, N),
        raw_value=zeros(B, N),
        prior=zeros(B, N, A),
        children=torch.full((B, N, A), UNVISITED, dtype=torch.int32, device=device),
        to_play=torch.full((B, N), -1, dtype=torch.int32, device=device),
        terminal=zeros(B, N, dt=torch.bool),
        is_chance=zeros(B, N, dt=torch.bool),
        legal=zeros(B, N, A, dt=torch.bool),
        embedding=map_embedding(alloc_embedding, embedding_example),
        # +1e6 / -1e6: delta stays <= 0 until the first update, so
        # normalization is off until then (tree.py:101-102)
        vmin=torch.full((B,), 1e6, dtype=dtype, device=device),
        vmax=torch.full((B,), -1e6, dtype=dtype, device=device),
    )


def _root_child_gather(tree: Tree, values: torch.Tensor) -> torch.Tensor:
    """(B, A) values[b, children[b, 0, a]] (child index clamped at 0)."""
    safe = torch.clamp(tree.children[:, 0, :], min=0).long()
    return torch.gather(values, 1, safe)


def root_visit_counts(tree: Tree) -> torch.Tensor:
    """(B, A) visit counts of root children; 0 for virtual children."""
    rc = tree.children[:, 0, :]
    visits = _root_child_gather(tree, tree.visit_count)
    return torch.where(rc >= 0, visits, 0)


def root_value(tree: Tree) -> torch.Tensor:
    """(B,) root mean value (the root has num_simulations + 1 visits)."""
    return tree.value_sum[:, 0] / torch.clamp(tree.visit_count[:, 0], min=1).to(
        tree.value_sum.dtype
    )


def root_children_values(tree: Tree, discount: float) -> torch.Tensor:
    """(B, A) per-root-child Q = r + gamma * V (0 if unvisited)."""
    rc = tree.children[:, 0, :]
    visits = _root_child_gather(tree, tree.visit_count)
    vals = _root_child_gather(tree, tree.node_value())
    q = _root_child_gather(tree, tree.reward) + discount * vals
    return torch.where((rc >= 0) & (visits > 0), q, 0.0)
