"""Image augmentations for the SSL consistency loss
(``lightzero_tpu/ops/augment.py``): ``random_shift`` (replicate-pad by 4
and crop back at a random offset) and ``intensity`` (a per-image scalar
gain), composed as ``augment_batch``, on NHWC tensors on their own device.

The draws come from a ``torch.Generator`` on the tensor's device, or are
passed in: ``shifts`` (B, 2) integer offsets in [0, 2 pad] (dy, dx) and
``noise`` (B,) standard normals, which ``intensity`` clips to [-2, 2]. A
test passes JAX's draws so that both sides augment alike.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def random_shift(imgs: torch.Tensor, pad: int = 4, generator: Optional[torch.Generator] = None,
                 shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, C): replicate-pad by ``pad``, then crop each image back to
    (H, W) at its offset ``shifts[b] = (dy, dx)`` (drawn uniformly from
    [0, 2 pad] when not given)."""
    B, H, W, _ = imgs.shape
    if shifts is None:
        shifts = torch.randint(0, 2 * pad + 1, (B, 2), generator=generator, device=imgs.device)
    shifts = shifts.to(imgs.device, torch.long)
    padded = F.pad(imgs.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="replicate")
    rows = shifts[:, 0, None] + torch.arange(H, device=imgs.device)  # (B, H)
    cols = shifts[:, 1, None] + torch.arange(W, device=imgs.device)  # (B, W)
    b = torch.arange(B, device=imgs.device)[:, None, None]
    return padded.permute(0, 2, 3, 1)[b, rows[:, :, None], cols[:, None, :]]


def intensity(imgs: torch.Tensor, scale: float = 0.05,
              generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-image multiplicative gain 1 + scale * clip(n, -2, 2), n a
    standard normal per image (Intensity, image_transform.py)."""
    B = imgs.shape[0]
    if noise is None:
        noise = torch.randn(B, generator=generator, device=imgs.device)
    gain = 1.0 + scale * torch.clamp(noise.to(imgs.device, imgs.dtype), -2.0, 2.0)
    return imgs * gain.reshape(B, 1, 1, 1)


def augment_batch(imgs: torch.Tensor, pad: int = 4, scale: float = 0.05,
                  generator: Optional[torch.Generator] = None,
                  shifts: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift, then intensity (the reference's default ``augmentation=
    ['shift', 'intensity']``)."""
    shifted = random_shift(imgs, pad, generator, shifts)
    return intensity(shifted, scale, generator, noise)
