"""Mixture-of-Experts feed-forward of the UniZero transformer
(``lightzero_tpu/models/unizero_world_model/moe.py``).

Routed dispatch: the gate selects each token's experts, the selected token
and expert pairs are grouped by expert, each expert's SwiGLU runs on its
own tokens only, and the weighted results are added back in place. The
selection is the JAX module's: a token goes to every expert whose logit is
at or above its k-th largest (``gate_logits >= kth``), so every expert that
ties the k-th logit stays in where ``torch.topk`` would keep exactly k, and
its weights are the softmax over the selected logits. The JAX module
computes the same sum densely, every expert on every token, the unselected
ones weighed 0.

Grouping reads the experts' token counts back to the host once a layer a
forward: they are the sizes of the experts' products. With
``n_shared_experts=1`` one more SwiGLU, ``shared``, runs on every token and
its output is added unweighted (DeepSeekMoE's shared expert, which the JAX
module does not have).

Spans (``utils/profiling.py``): ``moe.route`` (the gate, the selection, the
grouping and the read-back), ``moe.experts`` (the routed and the shared
products) and ``moe.combine`` (the weighted scatter back). While a profile
records, each forward also records its (E,) token counts, a device tensor,
under the counter ``moe.tokens_per_expert``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from lightzero_tpu_torch.models.common import lecun_normal_
from lightzero_tpu_torch.utils import profiling


def _linear(in_dim: int, out_dim: int, generator) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim, bias=False)
    lecun_normal_(layer.weight, generator)
    return layer


class SwiGLUFeedForward(nn.Module):
    """(SiLU(x W1) * (x W3)) W2; ``dense[0..2]`` are flax's ``Dense_0..2``
    (W1, W3, W2)."""

    def __init__(self, embed_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = 4 * embed_dim
        self.dense = nn.ModuleList([_linear(embed_dim, hidden, generator),
                                    _linear(embed_dim, hidden, generator),
                                    _linear(hidden, embed_dim, generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense[2](F.silu(self.dense[0](x)) * self.dense[1](x))


def select(gate_logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., E) logits -> (the selected experts, bool (..., E): the logits at
    or above the k-th largest; their weights (..., E): the softmax over the
    selected logits, 0 elsewhere)."""
    kth = torch.topk(gate_logits, k, dim=-1).values[..., -1:]
    chosen = gate_logits >= kth
    return chosen, torch.softmax(torch.where(chosen, gate_logits, float("-inf")), dim=-1)


def gate_weights(gate_logits: torch.Tensor, k: int) -> torch.Tensor:
    """(..., E) softmax over the logits at or above the k-th largest."""
    return select(gate_logits, k)[1]


def group_by_expert(chosen: torch.Tensor, weights: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """The selected pairs of (N, E) ``chosen``, grouped by expert: (their
    tokens (P,), expert 0's first, each expert's in token order; their
    weights (P,); each expert's count, read back to the host)."""
    N = chosen.shape[0]
    counts = chosen.sum(dim=0)
    profiling.count("moe.tokens_per_expert", counts)
    sizes = counts.tolist()
    # pair e * N + t is token t's selection of expert e; a stable sort puts
    # the selected pairs first, in that order
    flat = chosen.t().reshape(-1)
    pairs = torch.argsort((~flat).to(torch.uint8), stable=True)[:sum(sizes)]
    return pairs % N, weights.t().reshape(-1)[pairs], sizes


class MoELayer(nn.Module):
    """Top-k gated mixture of SwiGLU experts, plus ``n_shared_experts`` (0 or
    1) shared ones; ``gate`` and ``experts.e`` are flax's ``gate`` and
    ``expert_e``."""

    def __init__(self, embed_dim: int, num_experts: int = 4, num_experts_per_tok: int = 1,
                 n_shared_experts: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_shared_experts not in (0, 1):
            raise ValueError(f"n_shared_experts must be 0 or 1, not {n_shared_experts}: the port "
                             "has one shared expert of the routed experts' width")
        self.k = min(num_experts_per_tok, num_experts)
        self.gate = _linear(embed_dim, num_experts, generator)
        self.experts = nn.ModuleList(SwiGLUFeedForward(embed_dim, generator)
                                     for _ in range(num_experts))
        self.shared = SwiGLUFeedForward(embed_dim, generator) if n_shared_experts else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(-1, x.shape[-1])
        with profiling.span("moe.route"):
            token, weight, sizes = group_by_expert(*select(self.gate(h), self.k))
            rows = h.index_select(0, token).split(sizes)
        with profiling.span("moe.experts"):
            routed = torch.cat([expert(part) for expert, part in zip(self.experts, rows)])
            out = torch.zeros_like(h) if self.shared is None else self.shared(h)
        with profiling.span("moe.combine"):
            out = out.index_add(0, token, routed * weight[:, None])
        return out.reshape(x.shape)
