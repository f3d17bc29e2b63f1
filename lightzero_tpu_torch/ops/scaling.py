"""Value scaling (MuZero Appendix F), ``lightzero_tpu/ops/scaling.py``:
``DiscreteSupport``, ``logits_to_scalar`` and ``inverse_scalar_transform``
for serving; ``scalar_transform``, ``phi_transform``, ``cross_entropy_loss``
and ``visit_count_temperature`` for training."""
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


def scalar_transform(x: torch.Tensor, epsilon: float = 0.001, delta: float = 1.0) -> torch.Tensor:
    """h(x) = sign(x)(sqrt(|x/delta|+1) - 1) + epsilon*x/delta (value
    compression)."""
    if delta != 1.0:
        x = x / delta
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + epsilon * x


def phi_transform(
    support: DiscreteSupport, x: torch.Tensor, label_smoothing_eps: float = 0.0
) -> torch.Tensor:
    """Real scalar (...,) -> two-hot categorical target (..., N): clamp to the
    support's range, split the mass between the two nearest atoms, optional
    label smoothing."""
    size = support.size
    min_bound = support.start
    max_bound = support.start + support.step * (size - 1)
    x = torch.clamp(x, min_bound, max_bound)
    pos = (x - min_bound) / support.step
    low = torch.floor(pos)
    p_high = pos - low
    p_low = 1.0 - p_high
    low_idx = low.long()
    high_idx = torch.clamp(low_idx + 1, max=size - 1)
    one_hot_low = torch.nn.functional.one_hot(low_idx, size).to(x.dtype)
    one_hot_high = torch.nn.functional.one_hot(high_idx, size).to(x.dtype)
    target = one_hot_low * p_low[..., None] + one_hot_high * p_high[..., None]
    if label_smoothing_eps > 0:
        target = (1.0 - label_smoothing_eps) * target + label_smoothing_eps / size
    return target


def cross_entropy_loss(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-sum target * log_softmax(prediction) over the last axis (...,)."""
    return -torch.sum(torch.log_softmax(prediction, dim=-1) * target, dim=-1)


def visit_count_temperature(
    manual_temperature_decay: bool,
    fixed_temperature_value: float,
    threshold_training_steps_for_final_temperature: int,
    trained_steps: int,
) -> float:
    """Piecewise visit-softmax temperature schedule: 1, 0.5, 0.25 at half and
    three quarters of the threshold when decaying, else the fixed value."""
    if manual_temperature_decay:
        if trained_steps < 0.5 * threshold_training_steps_for_final_temperature:
            return 1.0
        elif trained_steps < 0.75 * threshold_training_steps_for_final_temperature:
            return 0.5
        else:
            return 0.25
    return fixed_temperature_value
