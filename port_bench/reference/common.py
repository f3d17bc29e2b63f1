"""Plain float32 building blocks shared by the benchmark's references.

These are written from the published descriptions (MuZero, Schrittwieser et
al. 2020, Appendix F for the value transform; LightZero's model and ctree
sources for the layer order), in plain ``torch`` operations. Nothing here
imports the program under test, JAX or the JAX package.

Tensors of images are NHWC, as the configurations' observations are; each
convolution permutes to NCHW around ``torch.nn.functional.conv2d``. Linear
and convolution weights are (out, in) and (out, in, kh, kw). LayerNorms use
eps 1e-6 and normalise the last (channel) axis.

``Rounding`` is the numeric format of the operands of every convolution and
matrix product: ``FLOAT32`` leaves them as they are; ``TF32`` rounds them to
TF32's 10-bit significand, which is what the card's tensor cores do with TF32
switched on (they then accumulate in float32). The benchmark's controls run
the references under ``TF32``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.nn import functional as F

LAYER_NORM_EPS = 1e-6
Params = Dict[str, torch.Tensor]
Rounding = Callable[[torch.Tensor], torch.Tensor]


def FLOAT32(x: torch.Tensor) -> torch.Tensor:
    return x


def TF32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (8-bit exponent, 10-bit significand), to nearest,
    ties away from zero, kept in a float32 tensor; the gradient passes
    through the rounding unchanged."""
    bits = x.detach().to(torch.float32).contiguous().view(torch.int32)
    rounded = torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)
    return x + (rounded - x.detach())


def linear(x: torch.Tensor, w: torch.Tensor, b, rnd: Rounding) -> torch.Tensor:
    return F.linear(rnd(x), rnd(w), b)


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding along one axis (low, high): with stride 2 on an
    even size the extra row goes below."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int, rnd: Rounding) -> torch.Tensor:
    """SAME convolution without bias of an NHWC tensor."""
    k = w.shape[-1]
    top, bottom = same_pad(x.shape[1], k, stride)
    left, right = same_pad(x.shape[2], k, stride)
    y = rnd(x).permute(0, 3, 1, 2)
    if top == bottom and left == right:
        y = F.conv2d(y, rnd(w), stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(y, (left, right, top, bottom)), rnd(w), stride=stride)
    return y.permute(0, 2, 3, 1)


def layer_norm(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"],
                        LAYER_NORM_EPS)


def res_block(x: torch.Tensor, p: Params, name: str, rnd: Rounding) -> torch.Tensor:
    """conv3x3 -> LN -> relu -> conv3x3 -> LN, plus the input, relu."""
    y = torch.relu(layer_norm(conv(x, p[f"{name}.conv.0.weight"], 1, rnd), p, f"{name}.norm.0"))
    y = layer_norm(conv(y, p[f"{name}.conv.1.weight"], 1, rnd), p, f"{name}.norm.1")
    return torch.relu(x + y)


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, no padding, of an NHWC tensor."""
    B, H, W, C = x.shape
    return x[:, : H // 2 * 2, : W // 2 * 2].reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


def downsample(x: torch.Tensor, p: Params, name: str, rnd: Rounding) -> torch.Tensor:
    """The Atari pyramid with one res block a stage: conv s2 (C/2) -> LN ->
    relu -> res -> conv s2 (C) -> LN -> relu -> res -> pool -> res -> pool."""
    x = torch.relu(layer_norm(conv(x, p[f"{name}.conv.0.weight"], 2, rnd), p, f"{name}.norm.0"))
    x = res_block(x, p, f"{name}.res.0", rnd)
    x = torch.relu(layer_norm(conv(x, p[f"{name}.conv.1.weight"], 2, rnd), p, f"{name}.norm.1"))
    x = res_block(x, p, f"{name}.res.1", rnd)
    x = avg_pool(x)
    x = res_block(x, p, f"{name}.res.2", rnd)
    return avg_pool(x)


def mlp(x: torch.Tensor, p: Params, name: str, hidden: int, rnd: Rounding) -> torch.Tensor:
    """``hidden`` x (Linear -> LN -> relu), then a Linear."""
    for i in range(hidden):
        x = linear(x, p[f"{name}.dense.{i}.weight"], p[f"{name}.dense.{i}.bias"], rnd)
        x = torch.relu(layer_norm(x, p, f"{name}.norm.{i}"))
    return linear(x, p[f"{name}.dense.{hidden}.weight"], p[f"{name}.dense.{hidden}.bias"], rnd)


def sim_norm(x: torch.Tensor, group: int = 8) -> torch.Tensor:
    """Softmax within consecutive groups of ``group`` features."""
    return torch.softmax(x.reshape(*x.shape[:-1], -1, group), dim=-1).reshape(x.shape)


# ------------------------------------------------ value transform (App. F)

def support(scale: int, device) -> torch.Tensor:
    return torch.arange(-scale, scale + 1, dtype=torch.float32, device=device)


def h(x: torch.Tensor, eps: float = 0.001) -> torch.Tensor:
    """h(x) = sign(x)(sqrt(|x| + 1) - 1) + eps x."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def h_inverse(y: torch.Tensor, eps: float = 0.001) -> torch.Tensor:
    t = (torch.sqrt(1.0 + 4.0 * eps * (torch.abs(y) + 1.0 + eps)) - 1.0) / (2.0 * eps)
    return torch.sign(y) * (t * t - 1.0)


def logits_to_value(logits: torch.Tensor, scale: int) -> torch.Tensor:
    """The expected support value of categorical logits, through h^-1."""
    probs = torch.softmax(logits, dim=-1)
    return h_inverse(torch.sum(probs * support(scale, logits.device), dim=-1))


def two_hot(x: torch.Tensor, scale: int) -> torch.Tensor:
    """A scalar (already h-transformed) as two-hot weights on the support."""
    n = 2 * scale + 1
    pos = torch.clamp(x, -float(scale), float(scale)) + scale
    low = torch.floor(pos)
    p_high = pos - low
    low_i = low.long()
    high_i = torch.clamp(low_i + 1, max=n - 1)
    return (F.one_hot(low_i, n).to(x.dtype) * (1.0 - p_high)[..., None]
            + F.one_hot(high_i, n).to(x.dtype) * p_high[..., None])


def cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return -torch.sum(torch.log_softmax(logits, dim=-1) * target, dim=-1)


