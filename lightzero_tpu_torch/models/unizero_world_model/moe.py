"""Mixture-of-Experts feed-forward of the UniZero transformer
(``lightzero_tpu/models/unizero_world_model/moe.py``).

Dense dispatch, as in the JAX module: every expert runs on every token and
the gate's masked softmax weighs them. The mask keeps each logit at or above
the k-th largest (``gate_logits >= kth``), so every expert that ties the
k-th logit stays in, where ``torch.topk`` would keep exactly k. Plain torch
ops: the JAX module is plain jnp, no kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from lightzero_tpu_torch.models.common import lecun_normal_


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


def gate_weights(gate_logits: torch.Tensor, k: int) -> torch.Tensor:
    """(..., E) softmax over the logits at or above the k-th largest."""
    kth = torch.sort(gate_logits, dim=-1).values[..., -k, None]
    masked = torch.where(gate_logits >= kth, gate_logits, float("-inf"))
    return torch.softmax(masked, dim=-1)


class MoELayer(nn.Module):
    """Top-k gated mixture of SwiGLU experts; ``gate`` and ``experts.e`` are
    flax's ``gate`` and ``expert_e``."""

    def __init__(self, embed_dim: int, num_experts: int = 4, num_experts_per_tok: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = min(num_experts_per_tok, num_experts)
        self.gate = _linear(embed_dim, num_experts, generator)
        self.experts = nn.ModuleList(SwiGLUFeedForward(embed_dim, generator)
                                     for _ in range(num_experts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = gate_weights(self.gate(x), self.k)  # (..., E)
        outs = torch.stack([e(x) for e in self.experts], dim=-1)  # (..., D, E)
        return torch.einsum("...de,...e->...d", outs, weights)
