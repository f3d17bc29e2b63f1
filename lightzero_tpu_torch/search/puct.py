"""Batched pUCT MCTS (``lightzero_tpu/search/puct.py``), for single-player,
non-stochastic searches without reuse.

One call runs ``num_simulations`` iterations of
[pack tables -> fused descent -> recurrent_fn -> expand + backup] for a
whole batch of trees in lockstep. The descent is ``fused_traverse``: the
CUDA kernel on the card, its plain version on the CPU. The JAX search
compiles the loop into one XLA program; here it runs eagerly, and the tree
tensors are updated in place.

Not ported yet, and refused with ``NotImplementedError`` rather than
answered wrongly: ``players == 2`` (ROADMAP queue 1, slice 17, board games),
``stochastic`` chance nodes (slice 13, Stochastic MuZero) and the ReZero
reuse search, ``true_action`` (slice 15).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from lightzero_tpu_torch.search.fused_traverse import fused_traverse
from lightzero_tpu_torch.search.tree import (
    Tree,
    init_tree,
    map_embedding,
    root_children_values,
    root_value,
    root_visit_counts,
)
from lightzero_tpu_torch.search.types import (
    RecurrentOutput,
    RootOutput,
    SearchConfig,
    SearchOutput,
)
from lightzero_tpu_torch.utils.device import resolve_device

# recurrent_fn(action (B,) int64, parent embedding) -> RecurrentOutput
RecurrentFn = Callable[[torch.Tensor, Any], RecurrentOutput]


class _TraverseState(NamedTuple):
    """What the descent hands to expand + backup. Position 0 of the path
    tables holds the root's pre-backup stats, position i > 0 the stats of
    the node entered at depth i."""

    node: torch.Tensor  # (B,) leaf node (the stop node)
    depth: torch.Tensor  # (B,) int64
    path: torch.Tensor  # (B, D) int64 node indices along the path
    parent: torch.Tensor  # (B,) int64 node whose embedding the model expands
    last_action: torch.Tensor  # (B,) int64 action into the leaf
    virtual_to_play: torch.Tensor  # (B,) int32
    leaf_is_terminal_node: torch.Tensor  # (B,) bool stopped at a terminal
    path_reward: torch.Tensor  # (B, D)
    path_vsum: torch.Tensor  # (B, D) pre-backup value_sum
    path_visit: torch.Tensor  # (B, D) pre-backup visit count


def _check_scope(cfg: SearchConfig, true_action: Optional[torch.Tensor]) -> None:
    if cfg.players != 1:
        raise NotImplementedError(
            "players == 2 search is not ported yet (ROADMAP queue 1, slice 17: board games)"
        )
    if cfg.stochastic:
        raise NotImplementedError(
            "stochastic search is not ported yet (ROADMAP queue 1, slice 13: Stochastic MuZero)"
        )
    if true_action is not None:
        raise NotImplementedError(
            "reuse search (true_action) is not ported yet (ROADMAP queue 1, slice 15: ReZero)"
        )


def _pack_traverse_tables(tree: Tree) -> torch.Tensor:
    """Pack everything the descent reads into ONE (B, N, 7A+2) f32 table
    (puct.py:199-263). Per-child stats are gathered from the child rows into
    the parent row once per simulation. Columns: child index, prior, legal,
    child visit count, child value sum, child reward, child terminal (A
    each), the node's own visit count, is_chance (always 0 here)."""
    B, N, A = tree.num_trees, tree.num_nodes, tree.num_actions
    f32 = torch.float32
    ch = tree.children
    exists = ch >= 0
    safe = torch.clamp(ch, min=0).long().reshape(B, N * A)
    stats = torch.stack(
        [
            tree.visit_count.to(f32),
            tree.value_sum.to(f32),
            tree.reward.to(f32),
            tree.terminal.to(f32),
        ],
        dim=-1,
    )  # (B, N, 4)
    child_tab = torch.gather(stats, 1, safe[..., None].expand(B, N * A, 4)).reshape(B, N, A, 4)
    child_tab = torch.where(exists[..., None], child_tab, 0.0)
    return torch.cat(
        [
            ch.to(f32),
            tree.prior.to(f32),
            tree.legal.to(f32),
            child_tab[..., 0],
            child_tab[..., 1],
            child_tab[..., 2],
            child_tab[..., 3],
            tree.visit_count[..., None].to(f32),
            torch.zeros((B, N, 1), dtype=f32, device=ch.device),
        ],
        dim=2,
    ).contiguous()


def _traverse(
    cfg: SearchConfig,
    tree: Tree,
    to_play: torch.Tensor,
    generator: Optional[torch.Generator],
) -> _TraverseState:
    """Lockstep selection from the roots to unexpanded leaves through the
    fused descent (puct.py:335, unpacked as _traverse_pallas does,
    puct.py:266-332). The 'noise' tie-break's uniforms are drawn up front as
    one (max_depth, B, A) table, one row per depth."""
    B, N, A = tree.num_trees, tree.num_nodes, tree.num_actions
    max_depth = N + 1
    dev = tree.value_sum.device
    f32 = torch.float32
    packed = _pack_traverse_tables(tree)
    noise_u = None
    if cfg.tie_break != "first":
        noise_u = torch.rand((max_depth, B, A), generator=generator, device=dev, dtype=f32)
    root_stats = torch.stack(
        [
            tree.reward[:, 0].to(f32),
            tree.value_sum[:, 0].to(f32),
            tree.visit_count[:, 0].to(f32),
            torch.zeros((B,), dtype=f32, device=dev),
        ],
        dim=1,
    )
    scal, path, paction, preward, pvsum, pvisit = fused_traverse(
        packed,
        tree.vmin.to(f32).contiguous(),
        tree.vmax.to(f32).contiguous(),
        root_stats,
        noise_u,
        A=A,
        N=N,
        max_depth=max_depth,
        discount=float(cfg.discount),
        pb_c_base=float(cfg.pb_c_base),
        pb_c_init=float(cfg.pb_c_init),
        value_delta_max=float(cfg.value_delta_max),
        tie_break_first=cfg.tie_break == "first",
        tie_break_epsilon=float(cfg.tie_break_epsilon),
    )
    node = torch.round(scal[:, 0]).long()
    parent = torch.round(scal[:, 1]).long()
    depth = torch.round(scal[:, 3]).long()
    leaf_term = scal[:, 4] > 0.5
    path_i = torch.round(path).long()
    # virtual_to_play: -1 stays -1; 1 and 2 flip once per loop iteration
    # (depth + 1 iterations until done), as in the JAX loop
    tp = to_play.to(torch.int32)
    flipped = torch.where(tp == 1, 2, 1).to(torch.int32)
    vtp = torch.where(((depth + 1) % 2 == 1) & (tp != -1), flipped, tp)
    # a tree that stopped at an existing terminal node expands nothing; the
    # model is evaluated from the terminal node's predecessor
    bidx = torch.arange(B, device=dev)
    parent = torch.where(leaf_term, path_i[bidx, torch.clamp(depth - 1, min=0)], parent)
    return _TraverseState(
        node=node,
        depth=depth,
        path=path_i,
        parent=parent,
        last_action=torch.round(scal[:, 2]).long(),
        virtual_to_play=vtp,
        leaf_is_terminal_node=leaf_term,
        path_reward=preward.to(tree.value_sum.dtype),
        path_vsum=pvsum.to(tree.value_sum.dtype),
        path_visit=pvisit.to(tree.value_sum.dtype),
    )


def _expand_and_backup(
    cfg: SearchConfig,
    tree: Tree,
    st: _TraverseState,
    sim: int,
    out: RecurrentOutput,
    prior_is_logits: bool = False,
) -> Tree:
    """Expand the leaves (node sim + 1) and back the values up the paths
    (puct.py:544-708, players == 1). Updates the tree tensors in place.
    ``prior_is_logits``: the new row keeps the raw logits, illegal actions
    at -1e9, instead of their softmax (Gumbel trees, puct.py:572-574)."""
    B, N, A = tree.num_trees, tree.num_nodes, tree.num_actions
    dev = tree.value_sum.device
    dtype = tree.value_sum.dtype
    new_idx = sim + 1
    bidx = torch.arange(B, device=dev)

    legal_mask = (
        out.legal_mask
        if out.legal_mask is not None
        else torch.ones((B, A), dtype=torch.bool, device=dev)
    )
    terminal = (
        out.terminal if out.terminal is not None else torch.zeros((B,), dtype=torch.bool, device=dev)
    )
    # trees that stopped at an existing terminal node do NOT expand
    do_expand = ~st.leaf_is_terminal_node

    # --- expand (Node.expand, ptree_mz.py:46-69) ---
    logits = out.prior_logits.to(dtype)
    if prior_is_logits:
        prior = torch.where(legal_mask, logits, -1e9)
    else:
        prior = torch.softmax(torch.where(legal_mask, logits, -torch.inf), dim=-1)
        prior = torch.where(legal_mask, prior, 0.0)

    def row_write(arr, new_row):
        m = do_expand.reshape((B,) + (1,) * (arr.dim() - 2))
        arr[:, new_idx] = torch.where(m, new_row.to(arr.dtype), arr[:, new_idx])
        return arr

    link = tree.children[bidx, st.parent, st.last_action]
    tree.children[bidx, st.parent, st.last_action] = torch.where(
        do_expand, torch.full_like(link, new_idx), link
    )
    row_write(tree.prior, prior)
    row_write(tree.legal, legal_mask)
    row_write(tree.reward, out.reward)
    row_write(tree.raw_value, out.value)
    row_write(tree.to_play, st.virtual_to_play)
    row_write(tree.terminal, terminal)
    map_embedding(row_write, tree.embedding, out.embedding)

    # --- backup ---
    # the recorded path plus the new leaf for expanding trees; trees stopped
    # at a terminal node already have the leaf at path[depth]
    leaf_pos = torch.where(do_expand, st.depth + 1, st.depth)
    P = st.path.shape[1]
    pos = torch.arange(P, device=dev)[None, :]
    exp_mask = (pos == leaf_pos[:, None]) & do_expand[:, None]  # (B, P)
    path = torch.where(exp_mask, new_idx, st.path)
    node_r = torch.where(exp_mask, out.reward.to(dtype)[:, None], st.path_reward)
    pre_vsum = torch.where(exp_mask, 0.0, st.path_vsum)
    pre_visit = torch.where(exp_mask, 0.0, st.path_visit)
    valid = pos < (leaf_pos + 1)[:, None]  # (B, P)
    value = out.value.to(dtype)

    # bootstrap recurrence (right to left): contrib at the leaf is its value,
    # contrib_i = r_{i+1} + g * contrib_{i+1}. A suffix composition of affine
    # maps g_i(x) = a_i x + b_i (identity past the leaf), composed by
    # doubling in log2(P) steps (puct.py:650-677 uses an associative scan).
    r_next = torch.cat([node_r[:, 1:], torch.zeros((B, 1), dtype=dtype, device=dev)], dim=1)
    valid_next = torch.cat(
        [valid[:, 1:], torch.zeros((B, 1), dtype=torch.bool, device=dev)], dim=1
    )
    a_sfx = torch.where(valid_next, torch.tensor(cfg.discount, dtype=dtype, device=dev), 1.0)
    b_sfx = torch.where(valid_next, r_next, 0.0)
    k = 1
    while k < P:
        # (A, B)[i] <- (A[i] * A[i+k], A[i] * B[i+k] + B[i]); identity past P
        a_far = torch.cat([a_sfx[:, k:], torch.ones((B, k), dtype=dtype, device=dev)], dim=1)
        b_far = torch.cat([b_sfx[:, k:], torch.zeros((B, k), dtype=dtype, device=dev)], dim=1)
        a_sfx, b_sfx = a_sfx * a_far, a_sfx * b_far + b_sfx
        k *= 2
    contrib = a_sfx * value[:, None] + b_sfx
    contrib = torch.where(valid, contrib, 0.0)

    # each path node appears once per path, so the scatter-add has a single
    # term per node (invalid positions add 0 to node 0)
    safe_path = torch.where(valid, path, 0)
    tree.value_sum.scatter_add_(1, safe_path, contrib)
    tree.visit_count.scatter_add_(1, safe_path, valid.to(tree.visit_count.dtype))

    # post-backup node values from the recorded pre-backup stats
    node_value = (pre_vsum + contrib) / (pre_visit + 1.0)
    q = node_r + cfg.discount * node_value
    vmin = torch.minimum(tree.vmin, torch.min(torch.where(valid, q, torch.inf), dim=1).values)
    vmax = torch.maximum(tree.vmax, torch.max(torch.where(valid, q, -torch.inf), dim=1).values)
    return tree._replace(vmin=vmin, vmax=vmax)


def prepare_roots(
    cfg: SearchConfig,
    tree: Tree,
    root: RootOutput,
    legal_mask: torch.Tensor,
    to_play: torch.Tensor,
    with_noise: bool = True,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tree:
    """Expand the roots (+1 visit) and mix Dirichlet noise into the legal
    priors (puct.py:711, Roots.prepare ptree_mz.py:217-242). ``noise`` (B, A)
    replaces the Dirichlet draw, for tests."""
    dtype = tree.value_sum.dtype
    logits = root.prior_logits.to(dtype)
    prior = torch.softmax(torch.where(legal_mask, logits, -torch.inf), dim=-1)
    prior = torch.where(legal_mask, prior, 0.0)
    if with_noise:
        if noise is None:
            # Dirichlet over the legal subset: iid Gamma(alpha), normalized
            alpha = torch.full(legal_mask.shape, cfg.root_dirichlet_alpha, dtype=dtype,
                               device=legal_mask.device)
            g = torch._standard_gamma(alpha, generator=generator)
            g = torch.where(legal_mask, g, 0.0)
            noise = g / torch.clamp(g.sum(dim=-1, keepdim=True), min=1e-30)
        w = cfg.root_noise_weight
        prior = prior * (1.0 - w) + noise.to(dtype) * w
        prior = torch.where(legal_mask, prior, 0.0)
    tree.prior[:, 0] = prior
    tree.legal[:, 0] = legal_mask
    tree.visit_count[:, 0] = 1
    tree.raw_value[:, 0] = root.value.to(dtype)
    tree.to_play[:, 0] = to_play.to(torch.int32)

    def set_root(store, new):
        store[:, 0] = new
        return store

    map_embedding(set_root, tree.embedding, root.embedding)
    return tree


@torch.no_grad()
def batch_puct_search(
    root: RootOutput,
    recurrent_fn: RecurrentFn,
    cfg: SearchConfig,
    legal_mask: torch.Tensor,
    to_play: Optional[torch.Tensor] = None,
    with_noise: bool = True,
    noise: Optional[torch.Tensor] = None,
    true_action: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
) -> SearchOutput:
    """Run the full batched search (puct.py:756-825).

    The search runs on ``device``: ``cuda`` unless the caller names another;
    the root tensors are moved there. ``generator`` (on that device) draws
    the Dirichlet noise and the 'noise' tie-break uniforms."""
    _check_scope(cfg, true_action)
    dev = resolve_device(device)
    root = RootOutput(
        prior_logits=root.prior_logits.to(dev),
        value=root.value.to(dev),
        embedding=map_embedding(lambda e: e.to(dev), root.embedding),
    )
    legal_mask = legal_mask.to(dev)
    B, A = legal_mask.shape
    N = cfg.num_simulations + 1
    if to_play is None:
        to_play = torch.full((B,), -1, dtype=torch.int32, device=dev)
    to_play = to_play.to(dev)

    tree = init_tree(B, N, A, root.embedding, dtype=root.prior_logits.dtype, device=dev)
    tree = prepare_roots(cfg, tree, root, legal_mask, to_play, with_noise, noise, generator)
    bidx = torch.arange(B, device=dev)
    for sim in range(cfg.num_simulations):
        st = _traverse(cfg, tree, to_play, generator)
        parent_embedding = map_embedding(lambda e: e[bidx, st.parent], tree.embedding)
        out = recurrent_fn(st.last_action, parent_embedding)
        tree = _expand_and_backup(cfg, tree, st, sim, out)

    return SearchOutput(
        visit_counts=root_visit_counts(tree),
        root_value=root_value(tree),
        root_children_values=root_children_values(tree, cfg.discount),
        improved_policy=None,
        tree=tree,
    )
