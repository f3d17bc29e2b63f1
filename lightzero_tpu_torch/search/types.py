"""Shared types of the batched search (``lightzero_tpu/search/types.py``).

The JAX ``SearchConfig`` also carries ``gather_mode`` (a TPU lowering
choice) and ``use_pallas_traverse``; neither has a counterpart here. The
port's descent always goes through ``search/fused_traverse.py``: the CUDA
kernel for tensors on the card, its plain version for tensors on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Static search hyperparameters (pUCT constants of the reference
    default_config, lzero/policy/muzero.py:216-218 and cnode.cpp:655)."""

    num_simulations: int = 50
    pb_c_base: float = 19652.0
    pb_c_init: float = 1.25
    discount: float = 0.997
    value_delta_max: float = 0.01
    root_dirichlet_alpha: float = 0.3
    root_noise_weight: float = 0.25
    # 1 = single-player backup. 2 = two-player self-play: the generic
    # descent, and a backup that flips signs by the path's players
    # (search/puct.py); a tree whose root has no player (to_play -1, against
    # the bot) searches as one player.
    players: int = 1
    # 'noise': random tie-break among epsilon-close maxima (reference
    # cselect_child, cnode.cpp:551). 'first': lowest-index argmax.
    tie_break: str = "noise"
    tie_break_epsilon: float = 1e-6
    # Stochastic MuZero: decision and chance nodes alternate; a chance node
    # samples its child from the prior over outcomes (Gumbel-max), and the
    # search takes the generic descent instead of the descent kernel.
    stochastic: bool = False


class RootOutput(NamedTuple):
    """Output of initial_inference at the roots."""

    prior_logits: torch.Tensor  # (B, A)
    value: torch.Tensor  # (B,) scalar (already inverse-transformed)
    embedding: Any  # tensor or dict of (B, ...) tensors


class RecurrentOutput(NamedTuple):
    """Output of recurrent_inference for one search step. ``legal_mask`` and
    ``terminal`` serve env-as-simulator search and chance nodes; model-based
    callers leave them None (all legal, never terminal, no chance node)."""

    reward: torch.Tensor  # (B,)
    value: torch.Tensor  # (B,)
    prior_logits: torch.Tensor  # (B, A)
    embedding: Any  # tensor or dict of (B, ...) tensors
    legal_mask: Optional[torch.Tensor] = None  # (B, A) bool
    terminal: Optional[torch.Tensor] = None  # (B,) bool
    is_chance: Optional[torch.Tensor] = None  # (B,) bool the new node is a chance node


class SearchOutput(NamedTuple):
    visit_counts: torch.Tensor  # (B, A) root child visit counts
    root_value: torch.Tensor  # (B,) root mean value
    root_children_values: torch.Tensor  # (B, A) per-child Q (0 if unvisited)
    improved_policy: Optional[torch.Tensor]  # Gumbel only; None here
    tree: Any  # the full Tree
