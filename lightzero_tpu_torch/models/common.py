"""Shared neural building blocks, MLP family (``lightzero_tpu/models/common.py``
:24-193, 345-377): ``NetworkOutput``, ``_norm``, ``MLPTorso``, the MuZero MLP
representation, dynamics and prediction networks and the SSL projector.

Parity with the flax modules: LayerNorm uses eps 1e-6 (flax's default, torch's
is 1e-5); ``nn.Linear`` holds its weight as (out, in) where a flax Dense
kernel is (in, out) (``utils/params_import.py`` transposes); weights are
initialised as flax does (lecun-normal kernels, zero biases, zero last
layers where ``last_linear_layer_init_zero``), from an optional
``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence

import torch
from torch import nn

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


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax ``lecun_normal``: truncated normal at +-2 std with variance
    1/fan_in (the std is divided by the truncation's own std, .8796)."""
    fan_in = weight.shape[1]
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
