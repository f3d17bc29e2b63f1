"""Action selection from root visit counts (``lightzero_tpu/ops/action.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample_from_visit_counts(
    visit_counts: torch.Tensor,
    temperature: float = 1.0,
    deterministic: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched action selection.

    Args:
        visit_counts: (B, A) float or int visit counts (illegal actions = 0).
        temperature: visit-softmax temperature.
        generator: draws the categorical sample when not ``deterministic``.
    Returns:
        (actions (B,) int64, entropy (B,) in bits).
    """
    counts = visit_counts.to(torch.float32)
    logits = torch.where(
        counts > 0, torch.log(torch.clamp(counts, min=1e-30)), -torch.inf
    )
    logits = logits / temperature
    probs = torch.softmax(logits, dim=-1)
    ent = -torch.sum(
        torch.where(probs > 0, probs * torch.log2(torch.clamp(probs, min=1e-30)), 0.0),
        dim=-1,
    )
    if deterministic:
        actions = torch.argmax(counts, dim=-1)
    else:
        actions = torch.multinomial(probs, 1, generator=generator).squeeze(-1)
    return actions, ent
