"""ViT image encoder, UniZero's alternative tokenizer encoder
(``lightzero_tpu/models/vit.py``): a VALID patch convolution, a learned
position embedding, pre-norm encoder blocks, a final LayerNorm, the mean
over patches and a Dense to the embedding.

flax's ``MultiHeadDotProductAttention`` keeps its kernels as (D, heads, Dh)
for query, key and value and (heads, Dh, D) for the output; ``DenseGeneral``
here keeps them in that layout, so ``utils/params_import.py`` copies them as
they are. Module names follow flax's (``blocks.i`` for ``ViTBlock_i``,
``conv.0``, ``norm.i``, ``dense.i``). ``nn.gelu`` is the tanh approximation.
Plain torch ops: the JAX module is plain flax, no kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from lightzero_tpu_torch.models.common import LAYER_NORM_EPS, lecun_normal_


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` with bias, kernel in flax's layout: ``in_shape
    + out_shape``; the input's last ``len(in_shape)`` axes contract."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_in = len(in_shape)
        weight = torch.empty(math.prod(in_shape), math.prod(out_shape))
        with torch.no_grad():  # lecun-normal over the contracted axes
            nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
            weight.mul_(math.sqrt(1.0 / weight.shape[0]) / 0.87962566103423978)
        self.weight = nn.Parameter(weight.reshape(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - self.n_in]
        w = self.weight.reshape(math.prod(self.weight.shape[:self.n_in]), -1)
        y = x.reshape(*lead, -1) @ w
        return y.reshape(*lead, *self.bias.shape) + self.bias


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads)(x, x)``, no mask."""

    def __init__(self, dim: int, heads: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        dh = dim // heads
        self.query = DenseGeneral((dim,), (heads, dh), generator)
        self.key = DenseGeneral((dim,), (heads, dh), generator)
        self.value = DenseGeneral((dim,), (heads, dh), generator)
        self.out = DenseGeneral((heads, dh), (dim,), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # (B, N, H, Dh)
        q = q / math.sqrt(q.shape[-1])
        att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", att, v))


def _linear(in_dim: int, out_dim: int, generator) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = nn.ModuleList(nn.LayerNorm(dim, eps=LAYER_NORM_EPS) for _ in range(2))
        self.attn = MultiHeadAttention(dim, heads, generator)
        self.dense = nn.ModuleList([_linear(dim, mlp_ratio * dim, generator),
                                    _linear(mlp_ratio * dim, dim, generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm[0](x))
        h = F.gelu(self.dense[0](self.norm[1](x)), approximate="tanh")
        return x + self.dense[1](h)


class PatchConv(nn.Module):
    """flax ``nn.Conv(dim, (P, P), strides=(P, P), padding="VALID")`` with
    bias, on NHWC input."""

    def __init__(self, in_channels: int, dim: int, patch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(dim, in_channels, patch, patch))
        self.bias = nn.Parameter(torch.zeros(dim))
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, stride=self.patch)
        return y.permute(0, 2, 3, 1)


class ViT(nn.Module):
    """(B, H, W, C) image -> (B, out_dim) embedding."""

    def __init__(self, observation_shape: Tuple[int, int, int], out_dim: int = 256,
                 patch_size: int = 8, dim: int = 128, depth: int = 4, heads: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w, c = observation_shape
        n = (h // patch_size) * (w // patch_size)
        self.conv = nn.ModuleList([PatchConv(c, dim, patch_size, generator)])
        pos = torch.empty(1, n, dim)
        with torch.no_grad():
            pos.normal_(0.0, 0.02, generator=generator)
        self.pos_embed = nn.Parameter(pos)
        self.blocks = nn.ModuleList(ViTBlock(dim, heads, generator=generator) for _ in range(depth))
        self.norm = nn.ModuleList([nn.LayerNorm(dim, eps=LAYER_NORM_EPS)])
        self.dense = nn.ModuleList([_linear(dim, out_dim, generator)])

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = self.conv[0](obs)
        x = x.reshape(x.shape[0], -1, x.shape[-1]) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.dense[0](self.norm[0](x).mean(dim=1))
