"""Shared neural building blocks (``lightzero_tpu/models/common.py``):
``NetworkOutput``, ``_norm``, ``SimNorm``, ``MLPTorso``, the MuZero MLP representation,
dynamics and prediction networks and the SSL projector (:24-193, 345-377),
and the conv stack (:198-344): ``ResBlock``, ``DownSample`` and the conv
representation, dynamics and prediction networks.

Parity with the flax modules: LayerNorm uses eps 1e-6 (flax's default, torch's
is 1e-5); ``nn.Linear`` holds its weight as (out, in) where a flax Dense
kernel is (in, out) (``utils/params_import.py`` transposes); weights are
initialised as flax does (lecun-normal kernels, zero biases, zero last
layers where ``last_linear_layer_init_zero``), from an optional
``torch.Generator``.

The conv stack keeps the flax modules' NHWC layout in every tensor it takes
and gives (observations, latents, the tree's per-node embeddings); each
convolution permutes to NCHW (a channels-last view, no copy), convolves and
permutes back. So LayerNorm normalises over the channels only, as flax's
``nn.LayerNorm()`` on the last axis does, and the heads flatten in (h, w, c)
order, as flax's ``reshape(B, -1)`` does. A flax ``Conv`` kernel is HWIO,
a port ``ConvNHWC`` weight OIHW (``utils/params_import.py`` permutes). flax
``padding="SAME"`` pads (total // 2, total - total // 2) with
total = max((ceil(n / s) - 1) s + k - n, 0): with stride 2 on an even size
that is (0, 1), where torch's ``padding=1`` would pad (1, 1), so the port
pads explicitly (``same_padding``). ``nn.avg_pool`` is VALID:
``avg_pool2d(2, 2)`` without padding.

The convolutions, LayerNorms and average pools here are
``torch.nn.functional.conv2d``, ``layer_norm`` and ``avg_pool2d``: in the
JAX package they are flax ``nn.Conv``, ``nn.LayerNorm`` and ``nn.avg_pool``,
compiled by XLA outside any Pallas kernel, so nothing of the conv stack is a
TPU kernel to port, as a plain matrix product is not.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

LAYER_NORM_EPS = 1e-6


class NetworkOutput(NamedTuple):
    """Raw head outputs; the policy applies the inverse scalar transform."""

    value_logits: torch.Tensor  # (B, value_support)
    reward_logits: torch.Tensor  # (B, reward_support)
    policy_logits: torch.Tensor  # (B, A)
    latent_state: Any  # (B, latent)


def _norm(norm_type: Optional[str], dim: int) -> Optional[nn.Module]:
    if norm_type in ("LN", "BN", "layer_norm", "batch_norm"):
        # BN is mapped to LN, as in the JAX package
        return nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
    if norm_type in (None, "none"):
        return None
    raise ValueError(f"unsupported norm_type {norm_type!r}")


class SimNorm(nn.Module):
    """Simplicial normalization (flax ``SimNorm``, common.py:45-56): the
    last axis in groups of ``simnorm_dim``, each group softmaxed. No
    parameters."""

    def __init__(self, simnorm_dim: int = 8):
        super().__init__()
        self.simnorm_dim = simnorm_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shp = x.shape
        x = x.reshape(*shp[:-1], -1, self.simnorm_dim)
        return torch.softmax(x, dim=-1).reshape(shp)


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax ``lecun_normal``: truncated normal at +-2 std with variance
    1/fan_in (the std is divided by the truncation's own std, .8796). The
    fan-in is in for a Linear weight (out, in), kh kw c_in for a conv
    weight (out, in, kh, kw)."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        weight.mul_(std)
    return weight


class MLPTorso(nn.Module):
    """Dense -> norm -> relu for each hidden size, then a final Dense with
    optional norm and relu after it (flax ``MLPTorso``). ``dense[i]`` and
    ``norm[i]`` are flax's ``Dense_i`` and ``LayerNorm_i``."""

    def __init__(
        self,
        in_dim: int,
        hidden_sizes: Sequence[int],
        output_size: int,
        norm_type: Optional[str] = "LN",
        last_linear_layer_init_zero: bool = False,
        output_activation: bool = False,
        output_norm: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        sizes = [in_dim, *hidden_sizes, output_size]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        norms = [_norm(norm_type, h) for h in hidden_sizes]
        if output_norm:
            norms.append(_norm(norm_type, output_size))
        self.norm = nn.ModuleList(n for n in norms if n is not None)
        self.use_norm = norm_type not in (None, "none")
        self.output_norm = output_norm and self.use_norm
        self.output_activation = output_activation
        for i, layer in enumerate(self.dense):
            last = i == len(self.dense) - 1
            if last and last_linear_layer_init_zero:
                nn.init.zeros_(layer.weight)
            else:
                lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_hidden = len(self.dense) - 1
        for i in range(n_hidden):
            x = self.dense[i](x)
            if self.use_norm:
                x = self.norm[i](x)
            x = torch.relu(x)
        x = self.dense[n_hidden](x)
        if self.output_norm:
            x = self.norm[n_hidden](x)
        if self.output_activation:
            x = torch.relu(x)
        return x


class RepresentationNetworkMLP(nn.Module):
    """obs (B, obs_dim) -> latent (B, latent_dim): one hidden layer, output
    normalised and activated."""

    def __init__(self, obs_dim: int, latent_state_dim: int = 256, norm_type: str = "LN",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.torso = MLPTorso(
            obs_dim, (latent_state_dim,), latent_state_dim, norm_type=norm_type,
            output_norm=True, output_activation=True, generator=generator,
        )

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.torso(obs)


class DynamicsNetworkMLP(nn.Module):
    """(latent, action_encoding) -> (next_latent, reward_logits)."""

    def __init__(
        self,
        action_encoding_dim: int,
        latent_state_dim: int = 256,
        reward_support_size: int = 601,
        common_layer_num: int = 2,
        reward_head_hidden_channels: Sequence[int] = (32,),
        norm_type: str = "LN",
        res_connection_in_dynamics: bool = False,
        last_linear_layer_init_zero: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.res_connection_in_dynamics = res_connection_in_dynamics
        self.torso = MLPTorso(
            latent_state_dim + action_encoding_dim,
            (latent_state_dim,) * (common_layer_num - 1),
            latent_state_dim,
            norm_type=norm_type,
            output_norm=True,
            output_activation=True,
            generator=generator,
        )
        self.reward_head = MLPTorso(
            latent_state_dim, tuple(reward_head_hidden_channels), reward_support_size,
            norm_type=norm_type, last_linear_layer_init_zero=last_linear_layer_init_zero,
            generator=generator,
        )

    def forward(self, latent: torch.Tensor, action_encoding: torch.Tensor):
        next_latent = self.torso(torch.cat([latent, action_encoding], dim=-1))
        if self.res_connection_in_dynamics:
            next_latent = next_latent + latent
        return next_latent, self.reward_head(next_latent)


class PredictionNetworkMLP(nn.Module):
    """latent -> (value_logits, policy_logits): common torso, then separate
    value and policy heads."""

    def __init__(
        self,
        action_space_size: int,
        latent_state_dim: int,
        value_support_size: int = 601,
        common_layer_num: int = 2,
        value_head_hidden_channels: Sequence[int] = (32,),
        policy_head_hidden_channels: Sequence[int] = (32,),
        norm_type: str = "LN",
        last_linear_layer_init_zero: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        d = latent_state_dim
        self.torso = MLPTorso(
            d, (d,) * (common_layer_num - 1), d, norm_type=norm_type,
            output_norm=True, output_activation=True, generator=generator,
        )
        self.value_head = MLPTorso(
            d, tuple(value_head_hidden_channels), value_support_size, norm_type=norm_type,
            last_linear_layer_init_zero=last_linear_layer_init_zero, generator=generator,
        )
        self.policy_head = MLPTorso(
            d, tuple(policy_head_hidden_channels), action_space_size, norm_type=norm_type,
            last_linear_layer_init_zero=last_linear_layer_init_zero, generator=generator,
        )

    def forward(self, latent: torch.Tensor):
        x = self.torso(latent)
        return self.value_head(x), self.policy_head(x)


class SSLProjector(nn.Module):
    """SimSiam-style projector and predictor of the SSL consistency loss
    (flax ``SSLProjector``, ``lightzero_tpu/models/common.py:345``).

    ``forward(latent, with_grad=True)`` is predictor(projection(x)), the
    online branch; ``with_grad=False`` is the projection alone, the target
    branch (the caller stops its gradient). ``proj[i]``/``proj_norms[i]``,
    ``pred[i]`` and ``pred_norm`` are flax's ``proj_i``, ``proj_norms_i``,
    ``pred_i`` and ``pred_norm``."""

    def __init__(
        self,
        in_dim: int,
        proj_hid: int = 1024,
        proj_out: int = 1024,
        pred_hid: int = 512,
        pred_out: int = 1024,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.proj = nn.ModuleList(
            [nn.Linear(in_dim, proj_hid), nn.Linear(proj_hid, proj_hid), nn.Linear(proj_hid, proj_out)]
        )
        self.proj_norms = nn.ModuleList(
            nn.LayerNorm(d, eps=LAYER_NORM_EPS) for d in (proj_hid, proj_hid, proj_out)
        )
        self.pred = nn.ModuleList([nn.Linear(proj_out, pred_hid), nn.Linear(pred_hid, pred_out)])
        self.pred_norm = nn.LayerNorm(pred_hid, eps=LAYER_NORM_EPS)
        for layer in (*self.proj, *self.pred):
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, latent: torch.Tensor, with_grad: bool = True) -> torch.Tensor:
        x = latent.reshape(latent.shape[0], -1)
        for i, (dense, norm) in enumerate(zip(self.proj, self.proj_norms)):
            x = norm(dense(x))
            if i < 2:
                x = torch.relu(x)
        if not with_grad:
            return x
        y = torch.relu(self.pred_norm(self.pred[0](x)))
        return self.pred[1](y)


# ----------------------------- conv stack (image obs) -----------------------


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``padding="SAME"`` along one axis: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_out_size(size: int, kernel: int, stride: int) -> int:
    """An axis's size after a SAME conv: ceil(size / stride)."""
    return -(-size // stride)


class ConvNHWC(nn.Module):
    """flax ``nn.Conv(out, (k, k), strides=(s, s), padding="SAME",
    use_bias=False)`` on NHWC tensors; ``weight`` is (out, in, k, k),
    lecun-normal."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        (top, bottom), (left, right) = (same_padding(n, self.kernel, self.stride)
                                        for n in x.shape[2:])
        if top == bottom and left == right:
            y = F.conv2d(x, self.weight, stride=self.stride, padding=(top, left))
        else:
            y = F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight, stride=self.stride)
        return y.permute(0, 2, 3, 1)


def _layer_norm(channels: int) -> nn.LayerNorm:
    """A flax ``nn.LayerNorm()`` over the last (channel) axis of an NHWC
    tensor: eps 1e-6."""
    return nn.LayerNorm(channels, eps=LAYER_NORM_EPS)


def avg_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.avg_pool(x, (2, 2), strides=(2, 2))``: VALID, no padding."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class ResBlock(nn.Module):
    """conv3x3 -> LN -> relu -> conv3x3 -> LN, plus the input, then relu
    (flax ``ResBlock``). ``conv[i]``, ``norm[i]`` are flax's ``Conv_i``,
    ``LayerNorm_i``."""

    def __init__(self, channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.ModuleList(ConvNHWC(channels, channels, generator=generator)
                                  for _ in range(2))
        self.norm = nn.ModuleList(_layer_norm(channels) for _ in range(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm[0](self.conv[0](x)))
        y = self.norm[1](self.conv[1](y))
        return torch.relu(x + y)


class DownSample(nn.Module):
    """The Atari stride pyramid (flax ``DownSample``): conv s2 -> res ->
    conv s2 -> res -> avgpool 2 -> res -> avgpool 2 (96x96 -> 6x6). ``res``
    holds flax's ``ResBlock_0 .. ResBlock_{3n-1}`` in order."""

    def __init__(self, in_channels: int, out_channels: int = 64, num_resblocks: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = out_channels
        self.num_resblocks = num_resblocks
        self.conv = nn.ModuleList([ConvNHWC(in_channels, c // 2, 3, 2, generator),
                                   ConvNHWC(c // 2, c, 3, 2, generator)])
        self.norm = nn.ModuleList([_layer_norm(c // 2), _layer_norm(c)])
        widths = [c // 2] * num_resblocks + [c] * (2 * num_resblocks)
        self.res = nn.ModuleList(ResBlock(w, generator) for w in widths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.num_resblocks
        x = torch.relu(self.norm[0](self.conv[0](x)))
        for blk in self.res[:n]:
            x = blk(x)
        x = torch.relu(self.norm[1](self.conv[1](x)))
        for blk in self.res[n:2 * n]:
            x = blk(x)
        x = avg_pool_nhwc(x)
        for blk in self.res[2 * n:]:
            x = blk(x)
        return avg_pool_nhwc(x)


def conv_latent_shape(observation_shape: Sequence[int], num_channels: int,
                      downsample: bool) -> Tuple[int, int, int]:
    """(h, w, C) of the conv representation's latent for (H, W, C_in)
    observations: two SAME stride-2 convs and two VALID pools under
    ``downsample``, the input's size otherwise."""
    h, w = int(observation_shape[0]), int(observation_shape[1])
    if downsample:
        h, w = (conv_out_size(conv_out_size(n, 3, 2), 3, 2) // 2 // 2 for n in (h, w))
    return h, w, num_channels


class RepresentationNetworkConv(nn.Module):
    """obs (B, H, W, C_in) -> latent (B, h, w, C): the DownSample pyramid
    (``downsample``) or conv3x3 -> LN -> relu, then ``num_res_blocks`` res
    blocks (flax ``RepresentationNetworkConv``)."""

    def __init__(self, in_channels: int, num_channels: int = 64, num_res_blocks: int = 1,
                 downsample: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if downsample:
            self.downsample = DownSample(in_channels, num_channels, generator=generator)
        else:
            self.conv = nn.ModuleList([ConvNHWC(in_channels, num_channels, generator=generator)])
            self.norm = nn.ModuleList([_layer_norm(num_channels)])
        self.res = nn.ModuleList(ResBlock(num_channels, generator) for _ in range(num_res_blocks))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "downsample"):
            x = self.downsample(obs)
        else:
            x = torch.relu(self.norm[0](self.conv[0](obs)))
        for blk in self.res:
            x = blk(x)
        return x


def conv_transition(conv: ConvNHWC, norm: nn.LayerNorm, blocks, latent: torch.Tensor,
                    planes: torch.Tensor) -> torch.Tensor:
    """(latent (B, h, w, C), action planes (B, h, w, E)) -> next latent:
    conv3x3 of their concatenation -> LN, plus the latent, then relu, then
    the res blocks: the state path of every conv dynamics (flax
    ``DynamicsNetworkConv`` and the models' bare ``_dyn_conv``,
    ``_dyn_norm``, ``_dyn_blocks``)."""
    x = torch.relu(norm(conv(torch.cat([latent, planes], dim=-1))) + latent)
    for blk in blocks:
        x = blk(x)
    return x


def conv_reduce(conv: ConvNHWC, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """conv1x1 -> LN -> relu -> flatten in (h, w, c) order: what the heads'
    MLPs and EfficientZero's LSTM read."""
    r = torch.relu(norm(conv(x)))
    return r.reshape(r.shape[0], -1)


def action_planes(encoding: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
    """(B, E) action encoding -> (B, h, w, E) planes over the latent's grid."""
    B, h, w, _ = latent.shape
    return encoding.to(latent.dtype)[:, None, None, :].expand(B, h, w, encoding.shape[-1])


class DynamicsNetworkConv(nn.Module):
    """(latent, action planes) -> (next latent, reward logits) (flax
    ``DynamicsNetworkConv``): ``conv_transition`` through ``conv[0]``,
    ``norm[0]`` and ``res``, then the reward head ``conv[1]`` (1x1),
    ``norm[1]``, ``mlp[0]``; the lists hold flax's ``Conv_i``,
    ``LayerNorm_i``, ``ResBlock_i`` and ``MLPTorso_i``."""

    def __init__(self, num_channels: int, enc_channels: int, hw: int, num_res_blocks: int = 1,
                 reward_support_size: int = 601,
                 reward_head_hidden_channels: Sequence[int] = (32,),
                 reward_head_channels: int = 16, norm_type: str = "LN",
                 last_linear_layer_init_zero: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.ModuleList([
            ConvNHWC(num_channels + enc_channels, num_channels, generator=generator),
            ConvNHWC(num_channels, reward_head_channels, 1, generator=generator)])
        self.norm = nn.ModuleList([_layer_norm(num_channels), _layer_norm(reward_head_channels)])
        self.res = nn.ModuleList(ResBlock(num_channels, generator) for _ in range(num_res_blocks))
        self.mlp = nn.ModuleList([MLPTorso(
            hw * reward_head_channels, tuple(reward_head_hidden_channels), reward_support_size,
            norm_type=norm_type, last_linear_layer_init_zero=last_linear_layer_init_zero,
            generator=generator)])

    def forward(self, latent: torch.Tensor, planes: torch.Tensor):
        next_latent = conv_transition(self.conv[0], self.norm[0], self.res, latent, planes)
        return next_latent, self.mlp[0](conv_reduce(self.conv[1], self.norm[1], next_latent))


class PredictionNetworkConv(nn.Module):
    """latent (B, h, w, C) -> (value logits, policy logits) (flax
    ``PredictionNetworkConv``): the res blocks, then a 1x1-conv value head
    (``conv[0]``, ``norm[0]``, ``mlp[0]``) and policy head (``conv[1]``,
    ``norm[1]``, ``mlp[1]``)."""

    def __init__(self, action_space_size: int, num_channels: int, hw: int,
                 value_support_size: int = 601, num_res_blocks: int = 1,
                 value_head_channels: int = 16, policy_head_channels: int = 16,
                 value_head_hidden_channels: Sequence[int] = (32,),
                 policy_head_hidden_channels: Sequence[int] = (32,), norm_type: str = "LN",
                 last_linear_layer_init_zero: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.res = nn.ModuleList(ResBlock(num_channels, generator) for _ in range(num_res_blocks))
        heads = ((value_head_channels, value_head_hidden_channels, value_support_size),
                 (policy_head_channels, policy_head_hidden_channels, action_space_size))
        self.conv = nn.ModuleList(ConvNHWC(num_channels, c, 1, generator=generator)
                                  for c, _, _ in heads)
        self.norm = nn.ModuleList(_layer_norm(c) for c, _, _ in heads)
        self.mlp = nn.ModuleList(
            MLPTorso(hw * c, tuple(hidden), out, norm_type=norm_type,
                     last_linear_layer_init_zero=last_linear_layer_init_zero, generator=generator)
            for c, hidden, out in heads)

    def forward(self, latent: torch.Tensor):
        x = latent
        for blk in self.res:
            x = blk(x)
        value_logits, policy_logits = (mlp(conv_reduce(conv, norm, x))
                                       for conv, norm, mlp in zip(self.conv, self.norm, self.mlp))
        return value_logits, policy_logits
