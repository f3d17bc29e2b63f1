"""Batched pUCT MCTS (``lightzero_tpu/search/puct.py``), for one and two
players, with and without ReZero's reuse.

One call runs ``num_simulations`` iterations of
[pack tables -> descent -> recurrent_fn -> expand + backup] for a whole
batch of trees in lockstep. The JAX search compiles the loop into one XLA
program; here it runs eagerly, and the tree tensors are updated in place.

Two descents read the same packed table. One-player, non-stochastic
searches without reuse take ``fused_traverse``: the CUDA kernel on the card,
its plain version on the CPU. Stochastic searches (Stochastic MuZero's
chance nodes), ReZero's reuse searches (``true_action``, ``reuse_value``)
and every search with ``players == 2`` take the generic descent
``_generic_traverse``, the torch form of the JAX package's XLA
``_traverse``, which is plain jnp there and plain PyTorch here: one level of
every tree per step, with the done flags read back to the host once per
level where the JAX loop is a ``while_loop`` on the device. The JAX package
routes them the same way (puct.py:372-378).

The expand and backup, once a simulation, goes through ``fused_backup`` for
one-player searches over float32 trees: the CUDA kernel
``csrc/fused_backup.cu`` on the card (one launch where its plain version
``fused_backup_reference`` makes about 110 device ops at the Atari
search's shape), the plain version on the CPU. Two-player searches keep
the plain version, whose backup flips signs by the path's players. The JAX
package's backup is plain jnp in either case (puct.py:544-708).

Two players (board games, ``players == 2``): the reference decides one- or
two-player semantics at run time from the root's ``to_play``
(cnode.cpp cbatch_traverse; ptree_mz.py:525): -1, a board game played
against the bot, searches as one player, even under ``players == 2``.
Otherwise a child's value is seen from the mover's side (negated in the
pUCT score, and in the reuse arm), and the backup flips the sign of the
value and of the rewards at every node whose player is not the leaf's
(puct.py:167-175, 453-456, 642-707). The two-player branch is a branch of
the generic descent and of the backup, plain jnp in the JAX package and
plain PyTorch here: in neither package is it a kernel. Bot-mode searches
(``to_play`` -1 under ``players == 2``) take the generic descent too, as in
the JAX package, although their scores are one-player scores. A stochastic
two-player search needs nothing more: a chance node flips the player like
any other level, as in the JAX loop, and its outcome is drawn the same way.
The player bookkeeping of a descent (``next_to_play`` and the path's
``path_to_play``) is shared with the Gumbel descent (``search/gumbel.py``).

The reuse search (cnode.cpp:827 in the reference): at the root, once the
true action's child has visits, that arm scores only the normalised
r + discount * reuse_value, with no prior term; whenever the root picks the
true action the descent stops there, and the backup takes ``reuse_value``
as the leaf's value, whether the child was expanded in this simulation or
already existed (then it is re-used without expansion, like a terminal).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from lightzero_tpu_torch.search.fused_backup import (
    fused_backup,
    fused_backup_reference,
    kernel_takes,
)
from lightzero_tpu_torch.search.fused_traverse import _sum_in_order, fused_traverse
from lightzero_tpu_torch.search.tree import (
    Tree,
    init_tree,
    map_embedding,
    minmax_normalize,
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
from lightzero_tpu_torch.utils.profiling import span

# the widest action space whose child Q values the generic descent adds in
# order, one action after another
IN_ORDER_MAX_A = 64

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
    # (B,) bool, reuse searches only: the root picked the true action, so
    # the backup takes the reused value
    reuse_hit: Optional[torch.Tensor] = None
    # (B, D) int32, generic descent only: the player of each path node
    path_to_play: Optional[torch.Tensor] = None


def next_to_play(vtp: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """(B,) int32 the player one level further down for every tree still
    descending: 1 and 2 swap, -1 (one-player semantics) stays."""
    flipped = torch.where(vtp == 1, 2, torch.where(vtp == 2, 1, -1)).to(torch.int32)
    return torch.where(done, vtp, flipped)


def _check_scope(true_action: Optional[torch.Tensor],
                 reuse_value: Optional[torch.Tensor]) -> None:
    if (true_action is None) != (reuse_value is None):
        raise ValueError("a reuse search takes both true_action and reuse_value")


def _pack_traverse_tables(tree: Tree) -> torch.Tensor:
    """Pack everything the descent reads into ONE (B, N, 7A+2) f32 table
    (puct.py:199-263). Per-child stats are gathered from the child rows into
    the parent row once per simulation. Columns: child index, prior, legal,
    child visit count, child value sum, child reward, child terminal (A
    each), the node's own visit count, the node's is_chance."""
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
            tree.is_chance[..., None].to(f32),
        ],
        dim=2,
    ).contiguous()


class _Children(NamedTuple):
    """A node's children as its packed row holds them (puct.py:425-438);
    absent children have visit count, value and reward 0."""

    index: torch.Tensor  # (..., A) int64, -1 = virtual
    prior: torch.Tensor
    legal: torch.Tensor  # bool
    visit: torch.Tensor
    value_sum: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    terminal: torch.Tensor  # bool


def _children(rows: torch.Tensor, A: int) -> _Children:
    """Decode packed rows (..., 7A+2) (``_pack_traverse_tables``)."""
    index = torch.round(rows[..., :A]).long()
    exists = index >= 0
    visit = rows[..., 3 * A:4 * A]
    value_sum = rows[..., 4 * A:5 * A]
    return _Children(
        index=index,
        prior=rows[..., A:2 * A],
        legal=rows[..., 2 * A:3 * A] > 0.5,
        visit=torch.where(exists, visit, 0.0),
        value_sum=value_sum,
        value=torch.where(exists & (visit > 0), value_sum / torch.clamp(visit, min=1.0), 0.0),
        reward=torch.where(exists, rows[..., 5 * A:6 * A], 0.0),
        terminal=rows[..., 6 * A:7 * A] > 0.5,
    )


def _child_q_totals(cfg: SearchConfig, packed: torch.Tensor, A: int) -> torch.Tensor:
    """(B, N, 2): for every node, the sum of r + discount V over its visited
    legal children and their count, the two sums of compute_mean_q
    (puct.py:139-142). They depend on the node's row alone, which does not
    change during a descent, so they are taken once per simulation for all
    nodes rather than once per level; up to ``IN_ORDER_MAX_A`` actions the
    values are summed from the first action to the last, as XLA sums a few
    terms, above it by the library sum (XLA's order over many terms is not
    sequential either)."""
    ch = _children(packed, A)
    visited = (ch.visit > 0) & ch.legal
    q = torch.where(visited, ch.reward + cfg.discount * ch.value, 0.0)
    # XLA's sum runs in order only over a few terms; over wide action
    # spaces (Go 9x9, Chess) in-order adds would cost a launch an action
    total_q = _sum_in_order(q) if A <= IN_ORDER_MAX_A else q.sum(dim=-1)
    total_n = visited.sum(dim=-1).to(total_q.dtype)
    return torch.stack([total_q, total_n], dim=-1)


def _mean_q(
    total_q: torch.Tensor,
    total_n: torch.Tensor,
    is_root: torch.Tensor,
    parent_q: torch.Tensor,
) -> torch.Tensor:
    """compute_mean_q (puct.py:128) from a node's ``_child_q_totals``: the
    mean of the visited children's r + discount V; below the root, parent_q
    is mixed in with weight 1."""
    root_mean = total_q / torch.clamp(total_n, min=1.0)
    mixed = (parent_q + total_q) / (total_n + 1.0)
    return torch.where(is_root & (total_n > 0), root_mean, mixed)


def _ucb_scores(
    cfg: SearchConfig,
    tree: Tree,
    parent_visit: torch.Tensor,
    child_visit: torch.Tensor,
    child_value: torch.Tensor,
    child_reward: torch.Tensor,
    prior: torch.Tensor,
    legal: torch.Tensor,
    mean_q: torch.Tensor,
) -> torch.Tensor:
    """compute_ucb_score (puct.py:148) over (B, A); illegal children score
    -inf. Unvisited children take the parent's mean-Q as their value score.
    Under ``players == 2`` a tree whose root has a player sees its
    children's values from the mover's side, negated (puct.py:167-175)."""
    pv = parent_visit[:, None]
    pb_c = torch.log((pv + cfg.pb_c_base + 1.0) / cfg.pb_c_base) + cfg.pb_c_init
    pb_c = pb_c * torch.sqrt(pv) / (child_visit + 1.0)
    prior_score = pb_c * prior
    if cfg.players == 1:
        q = child_reward + cfg.discount * child_value
    else:
        one_p = tree.to_play[:, :1] == -1
        q = child_reward + cfg.discount * torch.where(one_p, child_value, -child_value)
    value_score = minmax_normalize(tree.vmin, tree.vmax, cfg.value_delta_max, q)
    value_score = torch.clamp(value_score, 0.0, 1.0)
    pq = minmax_normalize(tree.vmin, tree.vmax, cfg.value_delta_max, mean_q[:, None])
    pq = torch.clamp(pq, 0.0, 1.0)
    value_score = torch.where(child_visit > 0, value_score, pq)
    return torch.where(legal, prior_score + value_score, -torch.inf)


def _select_action(
    cfg: SearchConfig, scores: torch.Tensor, noise_u: Optional[torch.Tensor]
) -> torch.Tensor:
    """The argmax (puct.py:187): the lowest index under 'first'; under
    'noise' the largest of the uniforms ``noise_u`` (B, A) among the scores
    within epsilon of the maximum (the reference's random tie-break)."""
    if cfg.tie_break == "first":
        return torch.argmax(scores, dim=-1)
    max_s = torch.amax(scores, dim=-1, keepdim=True)
    near = scores >= max_s - cfg.tie_break_epsilon
    return torch.argmax(torch.where(near, noise_u, -torch.inf), dim=-1)


def _generic_traverse(
    cfg: SearchConfig,
    tree: Tree,
    to_play: torch.Tensor,
    packed: torch.Tensor,
    noise_u: Optional[torch.Tensor],
    noise_g: Optional[torch.Tensor],
    true_action: Optional[torch.Tensor] = None,
    reuse_value: Optional[torch.Tensor] = None,
) -> _TraverseState:
    """Lockstep selection from the roots to unexpanded leaves, one level of
    every tree per step (the XLA ``_traverse``, puct.py:335-541), on the
    packed table. At step t every tree that is still descending is at depth
    t, so row t of the (max_depth, B, A) tables ``noise_u`` ('noise'
    tie-break uniforms) and ``noise_g`` (Gumbel draws, stochastic searches)
    serves one depth. A chance node takes the outcome
    argmax(log(max(prior, 1e-30)) + g) over its legal outcomes instead of
    the pUCT argmax. With ``true_action`` and ``reuse_value`` (B,) the root
    scores and stops as the reuse search does (puct.py:444-460, 486-495).
    The loop reads the done flags back once per level and
    stops when every tree is done, as JAX's ``while_loop`` does, so path
    columns past the last level stay zero."""
    B, N, A = tree.num_trees, tree.num_nodes, tree.num_actions
    max_depth = N + 1
    dev = tree.value_sum.device
    dtype = tree.value_sum.dtype
    C = packed.shape[2]
    bidx = torch.arange(B, device=dev)
    q_totals = _child_q_totals(cfg, packed, A)

    def zeros(dt=torch.long):
        return torch.zeros((B,), dtype=dt, device=dev)

    node, depth, parent, last_action = zeros(), zeros(), zeros(), zeros()
    parent_q = zeros(dtype)
    is_root = torch.ones((B,), dtype=torch.bool, device=dev)
    done, leaf_term = zeros(torch.bool), zeros(torch.bool)
    vtp = to_play.to(torch.int32)
    path = torch.zeros((B, max_depth), dtype=torch.long, device=dev)
    path_reward = torch.zeros((B, max_depth), dtype=dtype, device=dev)
    path_vsum = torch.zeros_like(path_reward)
    path_visit = torch.zeros_like(path_reward)
    path_reward[:, 0] = tree.reward[:, 0]
    path_vsum[:, 0] = tree.value_sum[:, 0]
    path_visit[:, 0] = tree.visit_count[:, 0].to(dtype)
    path_to_play = torch.zeros((B, max_depth), dtype=torch.int32, device=dev)
    path_to_play[:, 0] = tree.to_play[:, 0]
    reuse = true_action is not None
    if reuse:
        true_action = true_action.to(dev, torch.long)
        reuse_value = reuse_value.to(dev, dtype)
        is_true = torch.arange(A, device=dev)[None, :] == true_action[:, None]  # (B, A)
        reuse_hit = zeros(torch.bool)

    for t in range(max_depth - 1):
        row = torch.gather(packed, 1, node[:, None, None].expand(B, 1, C))[:, 0]
        totals = torch.gather(q_totals, 1, node[:, None, None].expand(B, 1, 2))[:, 0]
        ch = _children(row, A)
        mean_q = _mean_q(totals[:, 0], totals[:, 1], is_root, parent_q)
        scores = _ucb_scores(cfg, tree, row[:, 7 * A], ch.visit, ch.value, ch.reward, ch.prior,
                             ch.legal, mean_q)
        if reuse:
            # carm_score (cnode.cpp:702): the visited true-action arm at the
            # root scores normalised(r + discount * reuse_value) alone
            ta = true_action[:, None]
            arm_value = reuse_value
            if cfg.players == 2:
                arm_value = torch.where(to_play == -1, reuse_value, -reuse_value)
            q_arm = torch.gather(ch.reward, 1, ta)[:, 0] + cfg.discount * arm_value
            v_arm = torch.clamp(
                minmax_normalize(tree.vmin, tree.vmax, cfg.value_delta_max, q_arm), 0.0, 1.0)
            visited_true = torch.gather(ch.visit, 1, ta)[:, 0] > 0
            override = (is_root & visited_true)[:, None] & is_true
            scores = torch.where(override, v_arm[:, None], scores)
        action = _select_action(cfg, scores, None if noise_u is None else noise_u[t])
        if cfg.stochastic:
            chance_logits = torch.where(ch.legal, torch.log(torch.clamp(ch.prior, min=1e-30)),
                                        -torch.inf)
            sampled = torch.argmax(chance_logits + noise_g[t], dim=-1)
            action = torch.where(row[:, 7 * A + 1] > 0.5, sampled, action)

        a1 = action[:, None]
        next_child = torch.gather(ch.index, 1, a1)[:, 0]
        child_is_terminal = torch.gather(ch.terminal, 1, a1)[:, 0]
        if reuse:
            # the descent stops whenever the root picks the true action
            # (cnode.cpp:894-897); an existing child is re-used without
            # expansion, like a terminal stop
            reuse_stop = is_root & ~done & (action == true_action)
            child_is_terminal = child_is_terminal | (reuse_stop & (next_child >= 0))
            reuse_hit = reuse_hit | reuse_stop
        now_done = ~done & ((next_child < 0) | child_is_terminal)
        move = ~done & (next_child >= 0)
        vtp = next_to_play(vtp, done)
        depth = torch.where(move, depth + 1, depth)
        new_node = torch.where(move, next_child, node)
        # stalled and done lanes write into columns past their own depth,
        # which the backup masks out
        path[:, t + 1] = new_node
        path_reward[:, t + 1] = torch.gather(ch.reward, 1, a1)[:, 0]
        path_vsum[:, t + 1] = torch.gather(ch.value_sum, 1, a1)[:, 0]
        path_visit[:, t + 1] = torch.gather(ch.visit, 1, a1)[:, 0]
        path_to_play[:, t + 1] = vtp
        parent = torch.where(now_done & (next_child < 0), node, parent)
        parent_q = torch.where(done, parent_q, mean_q)
        is_root = is_root & done
        last_action = torch.where(done, last_action, action)
        leaf_term = torch.where(now_done, child_is_terminal, leaf_term)
        done = done | now_done
        node = new_node
        if bool(done.all()):
            break
    # a tree that stopped at an existing terminal node expands nothing; the
    # model is evaluated from the terminal node's predecessor
    parent = torch.where(leaf_term, path[bidx, torch.clamp(depth - 1, min=0)], parent)
    return _TraverseState(
        node=node,
        depth=depth,
        path=path,
        parent=parent,
        last_action=last_action,
        virtual_to_play=vtp,
        leaf_is_terminal_node=leaf_term,
        path_reward=path_reward,
        path_vsum=path_vsum,
        path_visit=path_visit,
        reuse_hit=reuse_hit if reuse else None,
        path_to_play=path_to_play,
    )


def _traverse(
    cfg: SearchConfig,
    tree: Tree,
    to_play: torch.Tensor,
    generator: Optional[torch.Generator],
    chance_noise: Optional[torch.Tensor] = None,
    true_action: Optional[torch.Tensor] = None,
    reuse_value: Optional[torch.Tensor] = None,
) -> _TraverseState:
    """Lockstep selection from the roots to unexpanded leaves (puct.py:335):
    the generic descent for stochastic, reuse and two-player searches,
    ``fused_traverse`` otherwise (puct.py:372-378). The randomness is drawn
    up front as (max_depth, B, A) tables, one row per depth: the 'noise'
    tie-break's uniforms and, for stochastic searches, the chance nodes'
    Gumbel draws, which ``chance_noise`` replaces (for tests)."""
    B, N, A = tree.num_trees, tree.num_nodes, tree.num_actions
    max_depth = N + 1
    dev = tree.value_sum.device
    dtype = tree.value_sum.dtype
    packed = _pack_traverse_tables(tree)
    noise_u = None
    if cfg.tie_break != "first":
        noise_u = torch.rand((max_depth, B, A), generator=generator, device=dev, dtype=dtype)
    if cfg.players == 1 and not cfg.stochastic and true_action is None:
        return _fused_descent(cfg, tree, to_play, packed, noise_u)
    if cfg.stochastic and chance_noise is None:
        u = torch.rand((max_depth, B, A), generator=generator, device=dev, dtype=dtype)
        chance_noise = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))
    noise_g = chance_noise.to(dev, dtype) if cfg.stochastic else None
    return _generic_traverse(cfg, tree, to_play, packed, noise_u, noise_g, true_action, reuse_value)


def _fused_descent(
    cfg: SearchConfig,
    tree: Tree,
    to_play: torch.Tensor,
    packed: torch.Tensor,
    noise_u: Optional[torch.Tensor],
) -> _TraverseState:
    """The descent through ``fused_traverse`` (unpacked as JAX's
    _traverse_pallas does, puct.py:266-332)."""
    B, N, A = tree.num_trees, tree.num_nodes, tree.num_actions
    max_depth = N + 1
    dev = tree.value_sum.device
    f32 = torch.float32
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
    value_override: Optional[torch.Tensor] = None,
) -> Tree:
    """Expand the leaves (node sim + 1) and back the values up the paths
    (puct.py:544-708): ``fused_backup_reference`` says what it computes.
    Updates the tree tensors in place and returns the tree with its new
    vmin and vmax. One-player searches over float32 trees take
    ``fused_backup`` (the kernel on the card, the plain version on the CPU)
    where ``kernel_takes`` says so; two-player searches, whose backup flips
    signs by the path's players, and other dtypes take the plain version."""
    if kernel_takes(cfg, tree):
        return fused_backup(cfg, tree, st, sim, out, prior_is_logits, value_override)
    return fused_backup_reference(cfg, tree, st, sim, out, prior_is_logits, value_override)


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
    chance_noise: Optional[torch.Tensor] = None,
    reuse_value: Optional[torch.Tensor] = None,
) -> SearchOutput:
    """Run the full batched search (puct.py:756-825).

    The search runs on ``device``: ``cuda`` unless the caller names another;
    the root tensors are moved there. ``generator`` (on that device) draws
    the Dirichlet noise, the 'noise' tie-break uniforms and the chance
    nodes' Gumbel draws. ``chance_noise`` (num_simulations, N + 1, B, A),
    standard Gumbel draws, replaces the last (for tests: JAX draws its own
    table per simulation, puct.py:379-385). ``true_action`` (B,) with
    ``reuse_value`` (B,) selects ReZero's reuse search
    (search_with_reuse, mcts_ctree.py:368-465)."""
    _check_scope(true_action, reuse_value)
    dev = resolve_device(device)
    with span("puct.roots"):
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
        if reuse_value is not None:
            reuse_value = reuse_value.to(dev)

        tree = init_tree(B, N, A, root.embedding, dtype=root.prior_logits.dtype, device=dev)
        tree = prepare_roots(cfg, tree, root, legal_mask, to_play, with_noise, noise, generator)
        bidx = torch.arange(B, device=dev)
    for sim in range(cfg.num_simulations):
        with span("puct.select"):
            st = _traverse(cfg, tree, to_play, generator,
                           None if chance_noise is None else chance_noise[sim], true_action,
                           reuse_value)
            parent_embedding = map_embedding(lambda e: e[bidx, st.parent], tree.embedding)
        with span("model.recurrent"):
            out = recurrent_fn(st.last_action, parent_embedding)
        with span("puct.backup"):
            tree = _expand_and_backup(cfg, tree, st, sim, out, value_override=reuse_value)

    with span("puct.result"):
        return SearchOutput(
            visit_counts=root_visit_counts(tree),
            root_value=root_value(tree),
            root_children_values=root_children_values(tree, cfg.discount),
            improved_policy=None,
            tree=tree,
        )
