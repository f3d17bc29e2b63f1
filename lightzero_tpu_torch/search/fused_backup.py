"""The fused expand and backup: the tail of one pUCT simulation.

``fused_backup`` launches the hand-written Hopper kernel
``csrc/fused_backup.cu`` for tensors on the card and takes the plain
PyTorch version ``fused_backup_reference`` for tensors on the CPU. Both take
``puct._expand_and_backup``'s arguments and keep its contract: the tree's
tensors are updated in place, and the new ``vmin`` and ``vmax`` come back as
new tensors through ``tree._replace``.

The kernel serves one-player searches (``cfg.players == 1``) over float32
trees (``kernel_takes``), with each of the plain version's
options: ``prior_is_logits`` (Gumbel), ``value_override`` with the
descent's ``reuse_hit`` (ReZero), a recurrent output with ``is_chance``
(Stochastic MuZero), ``legal_mask`` or ``terminal``. Where the embedding is
one tensor the kernel copies the new row; an embedding made of several
tensors keeps the plain version's row write in PyTorch. It replaces no TPU
kernel (``csrc/fused_backup.cu`` says why it exists).

The kernel's launches are counted in ``_build.launches`` under
``fused_backup_launch``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import TYPE_CHECKING, Optional, Tuple

import torch

from lightzero_tpu_torch import _build
from lightzero_tpu_torch.search.tree import Tree, map_embedding
from lightzero_tpu_torch.search.types import RecurrentOutput, SearchConfig

if TYPE_CHECKING:
    from lightzero_tpu_torch.search.puct import _TraverseState


def _row_writer(do_expand: torch.Tensor, new_idx: int):
    """row_write(arr, new_row): ``new_row`` (B, ...) into node ``new_idx`` of
    each tree where ``do_expand`` (B,) is set; the other trees keep theirs."""

    def row_write(arr, new_row):
        m = do_expand.reshape((arr.shape[0],) + (1,) * (arr.dim() - 2))
        arr[:, new_idx] = torch.where(m, new_row.to(arr.dtype), arr[:, new_idx])
        return arr

    return row_write


def fused_backup_reference(
    cfg: SearchConfig,
    tree: Tree,
    st: "_TraverseState",
    sim: int,
    out: RecurrentOutput,
    prior_is_logits: bool = False,
    value_override: Optional[torch.Tensor] = None,
) -> Tree:
    """Expand the leaves (node sim + 1) and back the values up the paths
    (puct.py:544-708). Updates the tree tensors in place; a
    recurrent output with ``is_chance`` marks the new row's node kind.
    ``prior_is_logits``: the new row keeps the raw logits, illegal actions
    at -1e9, instead of their softmax (Gumbel trees, puct.py:572-574).
    ``value_override`` (B,) is backed up as the leaf value where the reuse
    descent set ``reuse_hit`` (puct.py:637-638)."""
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

    row_write = _row_writer(do_expand, new_idx)
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
    if out.is_chance is not None:
        row_write(tree.is_chance, out.is_chance)
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
    if value_override is not None:
        value = torch.where(st.reuse_hit, value_override.to(dtype), value)
    two_p = cfg.players == 2
    if two_p:
        # one-player semantics where the leaf has no player (bot mode,
        # puct.py:642-648); else the rewards and values of the nodes of the
        # leaf's player change sign on their way up
        leaf_to_play = st.virtual_to_play
        one_p = (leaf_to_play == -1)[:, None]  # (B, 1)
        same = torch.where(exp_mask, leaf_to_play[:, None], st.path_to_play) == leaf_to_play[:, None]
        node_r_signed = torch.where(same & ~one_p, -node_r, node_r)
    else:
        node_r_signed = node_r

    # bootstrap recurrence (right to left): contrib at the leaf is its value,
    # contrib_i = r_{i+1} + g * contrib_{i+1}. A suffix composition of affine
    # maps g_i(x) = a_i x + b_i (identity past the leaf), composed by
    # doubling in log2(P) steps (puct.py:650-677 uses an associative scan).
    r_next = torch.cat([node_r_signed[:, 1:], torch.zeros((B, 1), dtype=dtype, device=dev)],
                       dim=1)
    valid_next = torch.cat(
        [valid[:, 1:], torch.zeros((B, 1), dtype=torch.bool, device=dev)], dim=1
    )
    # the discount as a Python float (no copy from the host), 1.0 as a
    # 0-dim tensor of the tree's dtype, so that the result takes that dtype
    a_sfx = torch.where(valid_next, cfg.discount, torch.ones((), dtype=dtype, device=dev))
    b_sfx = torch.where(valid_next, r_next, 0.0)
    k = 1
    while k < P:
        # (A, B)[i] <- (A[i] * A[i+k], A[i] * B[i+k] + B[i]); identity past P
        a_far = torch.cat([a_sfx[:, k:], torch.ones((B, k), dtype=dtype, device=dev)], dim=1)
        b_far = torch.cat([b_sfx[:, k:], torch.zeros((B, k), dtype=dtype, device=dev)], dim=1)
        a_sfx, b_sfx = a_sfx * a_far, a_sfx * b_far + b_sfx
        k *= 2
    contrib = a_sfx * value[:, None] + b_sfx
    if two_p:
        contrib = torch.where(same | one_p, contrib, -contrib)
    contrib = torch.where(valid, contrib, 0.0)

    # each path node appears once per path, so the scatter-add has a single
    # term per node (invalid positions add 0 to node 0)
    safe_path = torch.where(valid, path, 0)
    tree.value_sum.scatter_add_(1, safe_path, contrib)
    tree.visit_count.scatter_add_(1, safe_path, valid.to(tree.visit_count.dtype))

    # post-backup node values from the recorded pre-backup stats
    node_value = (pre_vsum + contrib) / (pre_visit + 1.0)
    if two_p:
        node_value = torch.where(one_p, node_value, -node_value)
    q = node_r + cfg.discount * node_value
    vmin = torch.minimum(tree.vmin, torch.min(torch.where(valid, q, torch.inf), dim=1).values)
    vmax = torch.maximum(tree.vmax, torch.max(torch.where(valid, q, -torch.inf), dim=1).values)
    return tree._replace(vmin=vmin, vmax=vmax)


class _Args(ctypes.Structure):
    """csrc/fused_backup.cu:FusedBackupArgs, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "visit_count", "value_sum", "reward", "raw_value", "prior", "children", "to_play",
        "terminal", "is_chance", "legal", "embedding", "vmin", "vmax", "vmin_out", "vmax_out",
        "depth", "path", "parent", "last_action", "virtual_to_play", "leaf_is_terminal_node",
        "path_reward", "path_vsum", "path_visit", "reuse_hit",
        "leaf_reward", "leaf_value", "logits", "legal_mask", "leaf_terminal", "leaf_is_chance",
        "value_override", "leaf_embedding",
    )] + [("embedding_bytes", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in ("B", "A", "N", "P", "new_idx")
    ] + [("discount", ctypes.c_float), ("prior_is_logits", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _limits() -> Tuple[int, int]:
    """The widest action space and the longest path a launch takes, as the
    library states them (csrc/fused_backup.cu: the widest row of the warp
    softmax whose order it follows, and the path whose two tables fit one
    warp's shared memory)."""
    return _build.entry("fused_backup_max_actions")(), _build.entry("fused_backup_max_path")()


def kernel_takes(cfg: SearchConfig, tree: Tree) -> bool:
    """Whether ``fused_backup`` backs up this search: one player, float32
    trees and, on the card, no more actions than the kernel's limit. Other
    searches take ``fused_backup_reference``."""
    if cfg.players != 1 or tree.value_sum.dtype != torch.float32:
        return False
    return not _build.route("fused_backup", tree.value_sum) or tree.num_actions <= _limits()[0]


def _row_copied(store, row, B: int) -> bool:
    """Whether the kernel copies the embedding row: one contiguous tensor of
    the store's dtype and row shape."""
    return (isinstance(store, torch.Tensor) and isinstance(row, torch.Tensor)
            and row.dtype == store.dtype and row.device == store.device
            and tuple(row.shape) == (B,) + tuple(store.shape[2:])
            and store.is_contiguous() and row.is_contiguous())


def fused_backup(
    cfg: SearchConfig,
    tree: Tree,
    st: "_TraverseState",
    sim: int,
    out: RecurrentOutput,
    prior_is_logits: bool = False,
    value_override: Optional[torch.Tensor] = None,
) -> Tree:
    """Expand and backup: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Launches on the current stream without synchronising,
    and raises on a search, type or shape the kernel does not take."""
    if not _build.route("fused_backup", tree.value_sum):
        return fused_backup_reference(cfg, tree, st, sim, out, prior_is_logits, value_override)
    if cfg.players != 1:
        raise ValueError(f"the backup kernel backs up one-player searches, not players={cfg.players}")
    B, N, A = tree.num_trees, tree.num_nodes, tree.num_actions
    P = st.path.shape[1]
    max_actions, max_path = _limits()
    if A > max_actions:
        raise ValueError(f"the backup kernel takes up to {max_actions} actions, not {A}")
    if not 2 <= P <= max_path:
        raise ValueError(f"the backup kernel takes paths of 2 to {max_path} slots, not {P}")
    if not 0 <= sim < N - 1:
        raise ValueError(f"simulation {sim} expands node {sim + 1}, outside the tree's {N} nodes")
    if value_override is not None and st.reuse_hit is None:
        raise ValueError("value_override is backed up where the descent's reuse_hit is set, "
                         "and this descent has none")
    dev = tree.value_sum.device
    f32, i32, i64, flag = torch.float32, torch.int32, torch.int64, torch.bool
    check = _build.check
    copied = _row_copied(tree.embedding, out.embedding, B)
    vmin = torch.empty((B,), dtype=f32, device=dev)
    vmax = torch.empty((B,), dtype=f32, device=dev)
    args = _Args(
        visit_count=check("tree.visit_count", tree.visit_count, (B, N), dev, i32),
        value_sum=check("tree.value_sum", tree.value_sum, (B, N), dev, f32),
        reward=check("tree.reward", tree.reward, (B, N), dev, f32),
        raw_value=check("tree.raw_value", tree.raw_value, (B, N), dev, f32),
        prior=check("tree.prior", tree.prior, (B, N, A), dev, f32),
        children=check("tree.children", tree.children, (B, N, A), dev, i32),
        to_play=check("tree.to_play", tree.to_play, (B, N), dev, i32),
        terminal=check("tree.terminal", tree.terminal, (B, N), dev, flag),
        is_chance=check("tree.is_chance", tree.is_chance, (B, N), dev, flag),
        legal=check("tree.legal", tree.legal, (B, N, A), dev, flag),
        embedding=tree.embedding.data_ptr() if copied else None,
        vmin=check("tree.vmin", tree.vmin, (B,), dev, f32),
        vmax=check("tree.vmax", tree.vmax, (B,), dev, f32),
        vmin_out=vmin.data_ptr(),
        vmax_out=vmax.data_ptr(),
        depth=check("depth", st.depth, (B,), dev, i64),
        path=check("path", st.path, (B, P), dev, i64),
        parent=check("parent", st.parent, (B,), dev, i64),
        last_action=check("last_action", st.last_action, (B,), dev, i64),
        virtual_to_play=check("virtual_to_play", st.virtual_to_play, (B,), dev, i32),
        leaf_is_terminal_node=check("leaf_is_terminal_node", st.leaf_is_terminal_node, (B,),
                                    dev, flag),
        path_reward=check("path_reward", st.path_reward, (B, P), dev, f32),
        path_vsum=check("path_vsum", st.path_vsum, (B, P), dev, f32),
        path_visit=check("path_visit", st.path_visit, (B, P), dev, f32),
        reuse_hit=(check("reuse_hit", st.reuse_hit, (B,), dev, flag)
                   if value_override is not None else None),
        leaf_reward=check("out.reward", out.reward, (B,), dev, f32),
        leaf_value=check("out.value", out.value, (B,), dev, f32),
        logits=check("out.prior_logits", out.prior_logits, (B, A), dev, f32),
        legal_mask=check("out.legal_mask", out.legal_mask, (B, A), dev, flag),
        leaf_terminal=check("out.terminal", out.terminal, (B,), dev, flag),
        leaf_is_chance=check("out.is_chance", out.is_chance, (B,), dev, flag),
        value_override=check("value_override", value_override, (B,), dev, f32),
        leaf_embedding=out.embedding.data_ptr() if copied else None,
        embedding_bytes=(math.prod(tree.embedding.shape[2:]) * tree.embedding.element_size()
                         if copied else 0),
        B=B, A=A, N=N, P=P, new_idx=sim + 1,
        discount=float(cfg.discount),
        prior_is_logits=int(bool(prior_is_logits)),
    )
    if not copied:
        # an embedding of several tensors, or one not copied as bytes: the
        # plain version's row write
        map_embedding(_row_writer(~st.leaf_is_terminal_node, sim + 1), tree.embedding,
                      out.embedding)
    _build.launch("fused_backup_launch", dev, ctypes.byref(args))
    return tree._replace(vmin=vmin, vmax=vmax)
