"""Model-analysis metrics (``lightzero_tpu/models/analysis.py``; reference
lzero/model/utils.py: calculate_dormant_ratio, compute_effective_rank,
compute_average_weight_magnitude, the tensorboard 'analysis' families).
Each returns 0-d tensors on its input's device."""
from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn


def dormant_ratio(activations: torch.Tensor, tau: float = 0.025) -> torch.Tensor:
    """Fraction of dormant units: units whose mean |activation| is at most
    ``tau`` x the layer-mean activation (Sokar et al.). activations: (B, units)."""
    score = activations.abs().mean(dim=0)
    norm = score / torch.clamp(score.mean(), min=1e-9)
    return (norm <= tau).to(torch.float32).mean()


def effective_rank(features: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """exp(entropy of the normalised singular values) of a centred feature
    batch (B, d), in float32 (world_model.py:1861-1913)."""
    f = (features - features.mean(dim=0, keepdim=True)).to(torch.float32)
    s = torch.linalg.svdvals(f)
    p = s / torch.clamp(s.sum(), min=eps)
    entropy = -torch.where(p > eps, p * torch.log(torch.where(p > eps, p, 1.0)), 0.0).sum()
    return torch.exp(entropy)


def average_weight_magnitude(params: Union[nn.Module, Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Mean |w| over every parameter of a module (or every tensor of a dict)."""
    leaves = list(params.parameters() if isinstance(params, nn.Module) else params.values())
    total = sum(leaf.detach().abs().sum() for leaf in leaves)
    return total / sum(leaf.numel() for leaf in leaves)


def latent_norm_stats(latent: torch.Tensor) -> Dict[str, torch.Tensor]:
    """L2-norm statistics of a latent batch (muzero.py:643-644)."""
    norms = torch.linalg.vector_norm(latent.reshape(latent.shape[0], -1), dim=-1)
    return dict(latent_norm_mean=norms.mean(), latent_norm_max=norms.max(),
                latent_norm_min=norms.min())
