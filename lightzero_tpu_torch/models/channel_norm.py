"""The conv stack's LayerNorm over the channels of an NHWC map, fused with
the relu after it and the residual add before that relu:

    channel_norm(x, norm, residual=None)
        = relu(LayerNorm_C(x) * norm.weight + norm.bias [+ residual])

``channel_norm`` launches the hand-written CUDA kernel pair
``csrc/channel_norm.cu`` (forward; backward through ``_ChannelNorm``, a
``torch.autograd.Function``) for a float32 map on the card whose channels
are a multiple of 4 and at most the library's limit
(``channel_norm_max_channels()``, 256); its output, and each
row's mean and rstd, are bitwise those of aten's layer_norm, add and relu on
the card. A map on the card that the kernel cannot take raises a
ValueError: every conv model of the port gives it 16 to 96 float32
channels. Every CPU tensor takes the plain version
``channel_norm_reference``: ``F.layer_norm``, the add, ``torch.relu``, the
ops the conv stack ran before. A map on another device raises a ValueError
(``_build.route``). A map that is not contiguous (or not 16-byte
aligned) is copied first, as aten's layer_norm copies a map that is not
contiguous.

The ``nn.LayerNorm`` modules hold the parameters, so the flax names and the
checkpoints (``utils/params_import.py``) stay as they were. Under
``torch.no_grad()`` (the search) the kernel saves nothing; with autograd it
keeps each row's mean and rstd beside x and the output for the backward,
whose plain formula is ``channel_norm_backward_reference``.

Counters: ``_build.launches`` counts the calls of ``channel_norm_forward``
(one kernel) and ``channel_norm_backward`` (two kernels). While a
``torch.profiler`` profile is active each kernel's launch also appends the
HBM bytes it must move to ``profiling.counters`` under
``"channel_norm.bytes"``, a host number (no device op): the forward
reads x and the residual and writes y; the backward reads dy, x and y and
writes dx and the residual's gradient; each reads or writes its parameters.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from lightzero_tpu_torch import _build
from lightzero_tpu_torch.utils import profiling

F32 = 4  # bytes of a float32


def channel_norm_reference(x: torch.Tensor, norm: nn.LayerNorm,
                           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(norm(x) [+ residual]) in plain PyTorch: the conv stack's ops."""
    y = F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    if residual is not None:
        y = y + residual
    return torch.relu(y)


def channel_norm_backward_reference(
    dy: torch.Tensor, x: torch.Tensor, y: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
    weight: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's backward in plain PyTorch: (dx, dweight, dbias, dres)
    from the output's gradient ``dy``, the input ``x`` (..., C), the output
    ``y`` and each row's ``mean`` and ``rstd`` (x's leading shape). The
    relu's gradient g = dy where y > 0 is the residual's gradient; with
    x-hat = (x - mean) rstd and d = g weight,
    dx = rstd (d - mean_C(d) - x-hat mean_C(d x-hat))."""
    g = torch.where(y > 0, dy, torch.zeros((), dtype=dy.dtype))
    xhat = (x - mean[..., None]) * rstd[..., None]
    d = g * weight
    dx = rstd[..., None] * (d - d.mean(-1, keepdim=True) - xhat * (d * xhat).mean(-1, keepdim=True))
    lead = tuple(range(x.dim() - 1))
    return dx, (g * xhat).sum(lead), g.sum(lead), g


@functools.lru_cache(maxsize=None)
def _max_channels() -> int:
    """The widest row a launch takes, as the library states it."""
    return _build.entry("channel_norm_max_channels")()


def kernel_takes(x: torch.Tensor, norm: nn.LayerNorm,
                 residual: Optional[torch.Tensor] = None) -> bool:
    """Whether ``channel_norm`` launches the kernel: a float32 map on the
    card, C % 4 == 0 and C <= ``_max_channels()`` channels, the module's
    float32 weight and bias, a residual of x's shape and type. The rule is
    read from the input alone; a CPU map loads no library."""
    C = x.shape[-1] if x.dim() else 0
    w, b = norm.weight, norm.bias
    return (x.is_cuda and x.dtype == torch.float32 and C % 4 == 0
            and 0 < C <= _max_channels() and tuple(norm.normalized_shape) == (C,)
            and w is not None and b is not None and w.dtype == b.dtype == torch.float32
            and w.is_cuda and b.is_cuda
            and (residual is None or (residual.shape == x.shape and residual.is_cuda
                                      and residual.dtype == torch.float32)))


@functools.lru_cache(maxsize=None)
def _blocks(rows: int, C: int, backward: bool) -> int:
    """The blocks of a launch (csrc/channel_norm.cu: the rows covered once,
    at most what the card holds at once)."""
    n = _build.entry("channel_norm_blocks")(rows, C, int(backward))
    if n <= 0:
        raise RuntimeError(f"channel_norm: no launch shape for {rows} rows of {C} channels")
    return n


def _ready(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the kernel loads float4s)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             residual: Optional[torch.Tensor], eps: float, save: bool):
    """(y, x as launched, stats): stats (2, rows) holds each row's mean and
    rstd, only under ``save``."""
    C = x.shape[-1]
    x = _ready(x)
    res = None if residual is None else _ready(residual)
    weight, bias = _ready(weight), _ready(bias)
    rows = x.numel() // C
    y = torch.empty_like(x)
    stats = torch.empty((2, rows), dtype=torch.float32, device=x.device) if save else None
    if rows:
        mean = stats.data_ptr() if save else None
        _build.launch(
            "channel_norm_forward", x.device, x.data_ptr(),
            None if res is None else res.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            y.data_ptr(), mean, mean + F32 * rows if save else None, rows, C,
            _blocks(rows, C, False), eps)
        profiling.count("channel_norm.bytes", F32 * (rows * C * (3 if res is not None else 2)
                                                     + 2 * C))
    return y, x, stats


def _backward(dy: torch.Tensor, x: torch.Tensor, y: torch.Tensor, stats: torch.Tensor,
              weight: torch.Tensor, residual: bool):
    """(dx, dweight, dbias, dres or None) from the kernel pair."""
    C = x.shape[-1]
    dy, weight = _ready(dy), _ready(weight)
    rows = x.numel() // C
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if residual else None
    if not rows:
        dweight, dbias = torch.zeros((2, C), dtype=torch.float32, device=x.device)
        return dx, dweight, dbias, dres
    blocks = _blocks(rows, C, True)
    params = torch.empty((2, C), dtype=torch.float32, device=x.device)
    partial = torch.empty((blocks, 2 * C), dtype=torch.float64, device=x.device)
    _build.launch(
        "channel_norm_backward", x.device, dy.data_ptr(), x.data_ptr(), y.data_ptr(),
        stats.data_ptr(), weight.data_ptr(), dx.data_ptr(),
        None if dres is None else dres.data_ptr(), partial.data_ptr(), params.data_ptr(),
        params.data_ptr() + F32 * C, rows, C, blocks)
    # the row kernel, then the parameters' reduction
    profiling.count("channel_norm.bytes", F32 * (rows * C * (5 if residual else 4) + C))
    profiling.count("channel_norm.bytes", F32 * 2 * C)
    dweight, dbias = params
    return dx, dweight, dbias, dres


class _ChannelNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, residual, eps):
        y, x_in, stats = _forward(x, weight, bias, residual, eps, save=True)
        ctx.save_for_backward(x_in, y, stats, weight)
        ctx.residual = residual is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        if torch.is_grad_enabled():
            raise RuntimeError("channel_norm's backward is not differentiable (create_graph)")
        x, y, stats, weight = ctx.saved_tensors
        dx, dweight, dbias, dres = _backward(dy, x, y, stats, weight, ctx.residual)
        return dx, dweight, dbias, dres, None


def channel_norm(x: torch.Tensor, norm: nn.LayerNorm,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(norm(x) [+ residual]) over the last (channel) axis: the kernel
    on the card, the plain version on the CPU. A map on the card that
    ``kernel_takes`` refuses raises a ValueError. Launches on the current
    stream without synchronising."""
    if not _build.route("channel_norm", x):
        return channel_norm_reference(x, norm, residual)
    if not kernel_takes(x, norm, residual):
        raise ValueError(
            f"channel_norm: the kernel takes float32 maps of 4 to {_max_channels()} channels, a "
            f"multiple of 4, with float32 parameters and a residual of the map's shape; got "
            f"{x.dtype} {tuple(x.shape)} with parameters {tuple(norm.normalized_shape)}"
            + ("" if residual is None else f" and a {residual.dtype} residual "
               f"{tuple(residual.shape)}"))
    w, b = norm.weight, norm.bias
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad or (
            residual is not None and residual.requires_grad)):
        return _ChannelNorm.apply(x, w, b, residual, norm.eps)
    return _forward(x, w, b, residual, norm.eps, save=False)[0]
