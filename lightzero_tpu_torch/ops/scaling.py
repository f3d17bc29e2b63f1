"""Value scaling (MuZero Appendix F), the serving half of
``lightzero_tpu/ops/scaling.py``: ``DiscreteSupport``, ``logits_to_scalar``
and ``inverse_scalar_transform``."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DiscreteSupport(NamedTuple):
    """Evenly spaced categorical value support [start, stop) with ``step``."""

    start: float
    stop: float
    step: float = 1.0

    @property
    def size(self) -> int:
        return int((self.stop - self.start) / self.step + 1e-9)

    def arange(self, device: Optional[torch.device] = None) -> torch.Tensor:
        return self.start + self.step * torch.arange(
            self.size, dtype=torch.float32, device=device
        )


def _h_inverse(value: torch.Tensor, epsilon: float = 0.001) -> torch.Tensor:
    tmp = (torch.sqrt(1.0 + 4.0 * epsilon * (torch.abs(value) + 1.0 + epsilon)) - 1.0) / (
        2.0 * epsilon
    )
    return torch.sign(value) * (tmp * tmp - 1.0)


def logits_to_scalar(logits: torch.Tensor, support: DiscreteSupport) -> torch.Tensor:
    """Categorical logits (..., N) -> expected support value (...,)."""
    probs = torch.softmax(logits, dim=-1)
    return torch.sum(probs * support.arange(logits.device), dim=-1)


def inverse_scalar_transform(
    logits: torch.Tensor,
    support: DiscreteSupport,
    epsilon: float = 0.001,
    categorical_distribution: bool = True,
) -> torch.Tensor:
    """h^-1 of the (categorical) value head output -> real-valued scalar."""
    if categorical_distribution:
        value = logits_to_scalar(logits, support)
    else:
        value = logits.squeeze(-1) if logits.shape[-1] == 1 else logits
    return _h_inverse(value, epsilon)
