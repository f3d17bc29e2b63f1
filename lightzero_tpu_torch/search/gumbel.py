"""Batched Gumbel MuZero search (``lightzero_tpu/search/gumbel.py``), for
one and two players: Sequential Halving over Gumbel-perturbed scores at
the root, the argmax of pi' - N / (1 + sum N) below it, with
pi' = softmax(logits + sigma(completed Q)), and the improved policy
softmax(logits + sigma(completed Q)) at the root as the training target.

The tree and its backup are the pUCT search's (``search/puct.py``); the
tree's ``prior`` holds the raw policy logits here (illegal actions at
-1e9), softmaxed where they are read. The descent is plain PyTorch, as it is
plain jnp in the JAX package (no Pallas kernel): one level of every tree at
a time, until each tree reached an unexpanded child or a terminal node. The
JAX version stops on a data-dependent condition inside a
``jax.lax.while_loop``; here that test reads the done flags back to the
host once per level.

The completed-Q transform takes the reference's defaults, which no config
sets (qtransform_completed_by_mix_value, cnode.cpp:988): ``maxvisit_init``
50, ``value_scale`` 0.1, always min-max rescaled with epsilon 1e-6; the
Gumbel draws are unscaled (``gumbel_scale`` 1).

Two players (``players == 2``, board games): as in the pUCT search, the
root's ``to_play`` decides at run time. -1 (a game against the bot) keeps
one-player semantics; otherwise the completed Q of a child is
r - discount * V, the child's value seen from the mover's side
(gumbel.py:108-117), every level of the descent flips the player
(``puct.next_to_play``, the generic descent's bookkeeping) and the backup
flips the signs by the path's players (``puct._expand_and_backup``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from lightzero_tpu_torch.search.puct import (
    RecurrentFn,
    _expand_and_backup,
    _TraverseState,
    next_to_play,
)
from lightzero_tpu_torch.search.tree import (
    Tree,
    init_tree,
    map_embedding,
    root_children_values,
    root_value,
    root_visit_counts,
)
from lightzero_tpu_torch.search.types import RootOutput, SearchConfig, SearchOutput
from lightzero_tpu_torch.utils.device import resolve_device

_LOW_LOGIT = -1e9
_MAXVISIT_INIT = 50.0
_VALUE_SCALE = 0.1
_RESCALE_EPSILON = 1e-6


@dataclasses.dataclass(frozen=True)
class GumbelSearchConfig:
    num_simulations: int = 50
    max_num_considered_actions: int = 4
    discount: float = 0.997
    players: int = 1
    value_delta_max: float = 0.01  # the backup's min-max floor

    def as_puct(self) -> SearchConfig:
        return SearchConfig(
            num_simulations=self.num_simulations,
            discount=self.discount,
            players=self.players,
            value_delta_max=self.value_delta_max,
        )


def sequence_of_considered_visits(max_num_considered: int, num_simulations: int) -> np.ndarray:
    """Sequential-halving visit schedule (get_sequence_of_considered_visits):
    entry ``sim`` is the visit count a root action must have to be
    considered at that simulation."""
    if max_num_considered <= 1:
        return np.arange(num_simulations, dtype=np.int32)
    log2max = int(math.ceil(math.log2(max_num_considered)))
    seq = []
    visits = [0] * max_num_considered
    num_considered = max_num_considered
    while len(seq) < num_simulations:
        num_extra = max(1, num_simulations // (log2max * num_considered))
        for _ in range(num_extra):
            seq.extend(visits[:num_considered])
            for j in range(num_considered):
                visits[j] += 1
        num_considered = max(2, num_considered // 2)
    return np.asarray(seq[:num_simulations], np.int32)


def _completed_q(cfg: GumbelSearchConfig, tree: Tree, node: torch.Tensor):
    """sigma(completed Q) per action of ``node`` (B, A), with the node's
    logits, legal mask, child visit counts, child indices and total visits
    (qtransform_completed_by_mix_value, cnode.cpp:988). An unvisited child
    takes the mixed value v_mix of the node's raw value and the
    prior-weighted Q of its visited children; the completed values are
    min-max rescaled over the legal actions. Under ``players == 2`` a tree
    whose root has a player sees its children's values negated."""
    B = tree.num_trees
    bidx = torch.arange(B, device=node.device)
    row_children = tree.children[bidx, node]
    exists = row_children >= 0
    safe = torch.clamp(row_children, min=0).long()
    cvisit = torch.where(exists, torch.gather(tree.visit_count, 1, safe), 0)
    cvsum = torch.gather(tree.value_sum, 1, safe)
    cvalue = torch.where(
        exists & (cvisit > 0), cvsum / torch.clamp(cvisit, min=1).to(cvsum.dtype), 0.0
    )
    creward = torch.where(exists, torch.gather(tree.reward, 1, safe), 0.0)
    logits = tree.prior[bidx, node]  # raw logits, illegal = _LOW_LOGIT
    legal = tree.legal[bidx, node]

    if cfg.players == 1:
        q = creward + cfg.discount * cvalue
    else:
        one_p = tree.to_play[:, :1] == -1
        q = creward + cfg.discount * torch.where(one_p, cvalue, -cvalue)
    visited = (cvisit > 0) & legal
    probs = torch.softmax(torch.where(legal, logits, -torch.inf), dim=-1)
    sum_n = torch.sum(torch.where(legal, cvisit, 0), dim=-1).to(q.dtype)
    probs_sum = torch.sum(torch.where(visited, probs, 0.0), dim=-1)
    weighted_q = torch.sum(torch.where(visited, probs * q, 0.0), dim=-1) / torch.clamp(
        probs_sum, min=1e-12
    )
    weighted_q = torch.where(probs_sum > 0, weighted_q, 0.0)
    raw_v = tree.raw_value[bidx, node]
    v_mix = (raw_v + sum_n * weighted_q) / (sum_n + 1.0)

    completed = torch.where(visited, q, v_mix[:, None])
    cmax = torch.amax(torch.where(legal, completed, -torch.inf), dim=-1, keepdim=True)
    cmin = torch.amin(torch.where(legal, completed, torch.inf), dim=-1, keepdim=True)
    completed = (completed - cmin) / torch.clamp(cmax - cmin, min=_RESCALE_EPSILON)
    max_visit = torch.amax(torch.where(legal, cvisit, 0), dim=-1, keepdim=True).to(q.dtype)
    completed = completed * (_MAXVISIT_INIT + max_visit) * _VALUE_SCALE
    return completed, logits, legal, cvisit, row_children, sum_n


def _root_select(
    cfg: GumbelSearchConfig, tree: Tree, gumbel: torch.Tensor, considered_visit: int
) -> torch.Tensor:
    """(B,) root action: the best Gumbel-perturbed score among the legal
    actions with ``considered_visit`` visits (cselect_root_child,
    cnode.cpp:700, and score_considered, :1096)."""
    node = torch.zeros((tree.num_trees,), dtype=torch.long, device=gumbel.device)
    completed, logits, legal, cvisit, _, _ = _completed_q(cfg, tree, node)
    shifted = logits - torch.amax(torch.where(legal, logits, -torch.inf), dim=-1, keepdim=True)
    score = torch.clamp(gumbel + shifted + completed, min=_LOW_LOGIT)
    score = torch.where(cvisit == considered_visit, score, -torch.inf)
    score = torch.where(legal, score, -torch.inf)
    return torch.argmax(score, dim=-1)


def _interior_select(cfg: GumbelSearchConfig, tree: Tree, node: torch.Tensor) -> torch.Tensor:
    """(B,) action below the root (cselect_interior_child, cnode.cpp:747)."""
    completed, logits, legal, cvisit, _, sum_n = _completed_q(cfg, tree, node)
    probs = torch.softmax(torch.where(legal, logits + completed, -torch.inf), dim=-1)
    to_argmax = probs - cvisit.to(probs.dtype) / (1.0 + sum_n[:, None])
    to_argmax = torch.where(legal, to_argmax, -torch.inf)
    return torch.argmax(to_argmax, dim=-1)


def improved_policy(cfg: GumbelSearchConfig, tree: Tree) -> torch.Tensor:
    """(B, A) root improved policy softmax(logits + sigma(completed Q)),
    zero on illegal actions (get_policies, cnode.cpp:372): the Gumbel
    training target and action distribution."""
    node = torch.zeros((tree.num_trees,), dtype=torch.long, device=tree.prior.device)
    completed, logits, legal, _, _, _ = _completed_q(cfg, tree, node)
    probs = torch.softmax(torch.where(legal, logits + completed, -torch.inf), dim=-1)
    return torch.where(legal, probs, 0.0)


def _gumbel_traverse(
    cfg: GumbelSearchConfig,
    tree: Tree,
    considered_visit: int,
    to_play: torch.Tensor,
    gumbel: torch.Tensor,
) -> _TraverseState:
    """Deterministic descent of every tree (gumbel.py:174-277): the
    sequential-halving action at the root, the interior rule below it, one
    level per step until each tree stops at an unexpanded child or a
    terminal node. Records the path and its pre-backup stats as the pUCT
    descent does."""
    B, N = tree.num_trees, tree.num_nodes
    max_depth = N + 1
    dev = tree.value_sum.device
    dtype = tree.value_sum.dtype
    bidx = torch.arange(B, device=dev)

    node = torch.zeros((B,), dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    depth = torch.zeros((B,), dtype=torch.long, device=dev)
    parent = torch.zeros((B,), dtype=torch.long, device=dev)
    last_action = torch.zeros((B,), dtype=torch.long, device=dev)
    leaf_term = torch.zeros((B,), dtype=torch.bool, device=dev)
    path = torch.zeros((B, max_depth), dtype=torch.long, device=dev)
    path_reward = torch.zeros((B, max_depth), dtype=dtype, device=dev)
    path_vsum = torch.zeros((B, max_depth), dtype=dtype, device=dev)
    path_visit = torch.zeros((B, max_depth), dtype=dtype, device=dev)
    path_reward[:, 0] = tree.reward[:, 0]
    path_vsum[:, 0] = tree.value_sum[:, 0]
    path_visit[:, 0] = tree.visit_count[:, 0].to(dtype)
    vtp = to_play.to(torch.int32)
    path_to_play = torch.zeros((B, max_depth), dtype=torch.int32, device=dev)
    path_to_play[:, 0] = tree.to_play[:, 0]

    # the tree does not change during a descent, so the root's choice is
    # made once; every tree is at its root on the first step only
    action = _root_select(cfg, tree, gumbel, considered_visit)
    t = 0
    while True:
        if t > 0:
            action = _interior_select(cfg, tree, node)
        row_children = tree.children[bidx, node]
        exists = row_children >= 0
        safe = torch.clamp(row_children, min=0).long()
        next_child = row_children[bidx, action].long()
        child_is_terminal = torch.where(
            next_child >= 0, tree.terminal[bidx, torch.clamp(next_child, min=0)], False
        )
        now_done = ~done & ((next_child < 0) | child_is_terminal)
        move = ~done & (next_child >= 0)
        chosen = safe[bidx, action][:, None]
        has_child = exists[bidx, action]
        parent = torch.where(now_done & (next_child < 0), node, parent)
        node = torch.where(move, next_child, node)
        depth = torch.where(move, depth + 1, depth)
        last_action = torch.where(done, last_action, action)
        leaf_term = torch.where(now_done, child_is_terminal, leaf_term)
        vtp = next_to_play(vtp, done)
        path_to_play[:, t + 1] = vtp
        path[:, t + 1] = node
        path_reward[:, t + 1] = torch.where(
            has_child, torch.gather(tree.reward, 1, chosen)[:, 0], 0.0)
        path_vsum[:, t + 1] = torch.where(
            has_child, torch.gather(tree.value_sum, 1, chosen)[:, 0], 0.0)
        path_visit[:, t + 1] = torch.where(
            has_child, torch.gather(tree.visit_count, 1, chosen)[:, 0], 0).to(dtype)
        done = done | now_done
        t += 1
        if bool(done.all()):
            break
    # a tree stopped at an existing terminal node expands nothing; the model
    # is evaluated from the terminal node's predecessor
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
        path_to_play=path_to_play,
    )


@torch.no_grad()
def batch_gumbel_search(
    root: RootOutput,
    recurrent_fn: RecurrentFn,
    cfg: GumbelSearchConfig,
    legal_mask: torch.Tensor,
    to_play: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
) -> SearchOutput:
    """Run the full batched Gumbel search (gumbel.py:280-352).

    The search runs on ``device``: ``cuda`` unless the caller names another.
    ``gumbel`` (B, A), standard Gumbel draws, replaces the draw from
    ``generator`` (for tests); either way it is set to -inf on illegal
    actions."""
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
    dtype = root.prior_logits.dtype

    # the static sequential-halving schedule (one row of the reference's
    # table: num_considered = min(max_considered, num_simulations))
    num_considered = min(cfg.max_num_considered_actions, cfg.num_simulations)
    schedule = sequence_of_considered_visits(num_considered, cfg.num_simulations)

    if gumbel is None:
        u = torch.rand((B, A), generator=generator, device=dev, dtype=dtype)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))
    gumbel = torch.where(legal_mask, gumbel.to(dev, dtype), -torch.inf)

    tree = init_tree(B, N, A, root.embedding, dtype=dtype, device=dev)
    # the roots: raw logits as priors, +1 visit, the raw value kept
    tree.prior[:, 0] = torch.where(legal_mask, root.prior_logits.to(dtype), _LOW_LOGIT)
    tree.legal[:, 0] = legal_mask
    tree.visit_count[:, 0] = 1
    tree.raw_value[:, 0] = root.value.to(dtype)
    tree.to_play[:, 0] = to_play.to(torch.int32)

    def set_root(store, new):
        store[:, 0] = new
        return store

    map_embedding(set_root, tree.embedding, root.embedding)

    puct_cfg = cfg.as_puct()
    bidx = torch.arange(B, device=dev)
    for sim in range(cfg.num_simulations):
        st = _gumbel_traverse(cfg, tree, int(schedule[sim]), to_play, gumbel)
        parent_embedding = map_embedding(lambda e: e[bidx, st.parent], tree.embedding)
        out = recurrent_fn(st.last_action, parent_embedding)
        if out.legal_mask is not None:
            out = out._replace(
                prior_logits=torch.where(out.legal_mask, out.prior_logits, _LOW_LOGIT))
        tree = _expand_and_backup(puct_cfg, tree, st, sim, out, prior_is_logits=True)

    return SearchOutput(
        visit_counts=root_visit_counts(tree),
        root_value=root_value(tree),
        root_children_values=root_children_values(tree, cfg.discount),
        improved_policy=improved_policy(cfg, tree),
        tree=tree,
    )
