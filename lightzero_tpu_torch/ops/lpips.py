"""LPIPS perceptual distance for UniZero's reconstruction loss
(``lightzero_tpu/ops/lpips.py``; role of reference
lzero/model/unizero_world_models/lpips.py, which wraps a pretrained torch
VGG16).

The VGG16 feature trunk is frozen: ``LPIPS`` holds its convs and the
linear heads as non-persistent buffers, so they are in no optimizer and in
no state dict (the flax params tree has no LPIPS leaves either).
Pretrained weights load from an .npz at ``$LZT_LPIPS_WEIGHTS`` (keys
``convN_M/kernel`` in HWIO and ``linK``, taken by abs); without the file
the trunk is the JAX package's He-normal random trunk, drawn from
``np.random.default_rng(0)`` in the same order, so both packages hold the
same numbers. A head the file lacks weighs each channel 1/cout.

Inputs are NHWC in [0, 1], shifted and scaled as LPIPS does; an input with
other than 3 channels is averaged over its channels and repeated to 3.
Convs are SAME 3x3 (padding 1) and pools 2x2 VALID. On a small input the
trunk stops before a pool that would leave less than one pixel, so a 10x10
image reaches four taps and ``lpips_distance`` sums four heads.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightzero_tpu_torch.utils.device import resolve_device

# VGG16 conv plan: (layer_name, out_channels); 'M' = 2x2 max pool between
# blocks. LPIPS taps the last relu of each block.
_PLAN = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
]
_TAPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


@functools.lru_cache(maxsize=1)
def lpips_params() -> Dict[str, np.ndarray]:
    """The trunk's kernels (HWIO) and the heads' weights, as numpy arrays:
    those of ``$LZT_LPIPS_WEIGHTS`` where it has them, else the JAX
    package's draws. Read or drawn once a process, as the JAX module does
    (14.7M draws); ``LPIPS`` copies them, so the cached arrays stay as
    drawn."""
    path = os.environ.get("LZT_LPIPS_WEIGHTS", "")
    loaded = dict(np.load(path)) if path and os.path.exists(path) else {}
    rng = np.random.default_rng(0)
    params = {}
    cin = 3
    for item in _PLAN:
        if item == "M":
            continue
        name, cout = item
        if f"{name}/kernel" in loaded:
            k = loaded[f"{name}/kernel"].astype(np.float32)
        else:
            std = float(np.sqrt(2.0 / (3 * 3 * cin)))
            k = rng.normal(0.0, std, (3, 3, cin, cout)).astype(np.float32)
        params[name] = k
        cin = cout
    widths = dict(x for x in _PLAN if x != "M")
    for i, tap in enumerate(_TAPS):
        key = f"lin{i}"
        cout = widths[tap]
        if key in loaded:
            params[key] = np.abs(loaded[key].astype(np.float32)).reshape(cout)
        else:
            params[key] = np.full((cout,), 1.0 / cout, np.float32)
    return params


class LPIPS(nn.Module):
    """The frozen trunk and heads on ``device`` (``cuda`` unless the caller
    names another); ``forward(x, y)`` is ``lpips_distance``."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        dev = resolve_device(device)
        params = lpips_params()
        for item in _PLAN:
            if item != "M":
                name = item[0]
                kernel = torch.from_numpy(params[name]).permute(3, 2, 0, 1)
                self.register_buffer(name, kernel.to(dev, copy=True).contiguous(),
                                     persistent=False)
        for i in range(len(_TAPS)):
            self.register_buffer(f"lin{i}", torch.from_numpy(params[f"lin{i}"]).to(dev, copy=True),
                                 persistent=False)
        self.register_buffer("shift", torch.from_numpy(_SHIFT).reshape(1, 3, 1, 1).to(dev),
                             persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).reshape(1, 3, 1, 1).to(dev),
                             persistent=False)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, 3, H, W) in [0, 1] -> the tapped feature maps (NCHW)."""
        h = (2.0 * x - 1.0 - self.shift) / self.scale
        feats = []
        for item in _PLAN:
            if item == "M":
                if h.shape[2] < 2 or h.shape[3] < 2:
                    break  # small inputs: stop before pooling away all pixels
                h = F.max_pool2d(h, 2, 2)
                continue
            name = item[0]
            h = F.relu(F.conv2d(h, getattr(self, name), padding=1))
            if name in _TAPS:
                feats.append(h)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Perceptual distance per batch element. x, y: (B, H, W, C) in [0, 1]."""
        def to3(v):
            v = v.permute(0, 3, 1, 2)
            if v.shape[1] == 3:
                return v
            return v.mean(dim=1, keepdim=True).expand(-1, 3, -1, -1)

        total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for i, (a, b) in enumerate(zip(self.features(to3(x)), self.features(to3(y)))):
            na = a / torch.sqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
            nb = b / torch.sqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2
            w = getattr(self, f"lin{i}").reshape(1, -1, 1, 1)
            total = total + (d * w).sum(dim=1).mean(dim=(1, 2))
        return total


def lpips_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Perceptual distance per batch element of NHWC images in [0, 1], on
    the inputs' device, through a trunk built there for this call (a caller
    that calls it often holds an ``LPIPS``, as the UniZero policy does)."""
    return LPIPS(x.device)(x, y)
