"""Sampled MuZero model (``lightzero_tpu/models/sampled_muzero.py``
:28-279): MuZero's representation and SSL projector, a prediction
network whose policy side is a Gaussian head (mu, sigma) over a continuous
action of ``action_space_size`` dimensions, or ``action_space_size`` logits
when ``continuous_action_space`` is False, and a dynamics network fed the
raw action vector (the one-hot action when discrete).

- ``prediction``: a common torso, then the value head and either the mu and
  sigma heads (``1.5 tanh(mu)`` under ``bound_mu``; sigma either
  ``sigma_min + (sigma_max - sigma_min) sigmoid(raw)``, 'conditioned', or
  ``fixed_sigma_value``, 'fixed') or the policy logits head;
- ``dynamics``: latent ⊕ action encoding -> next latent (output normalised
  and activated), then the reward head on the next latent.

``model_type='conv'`` (flax ``_setup_conv``, :128-160, used at :175, 201,
252): the conv representation, a ``PredictionNetworkConv`` whose policy head
emits concat[mu_raw, sigma_raw] (2 D units; A logits when discrete) split in
halves, and a ``DynamicsNetworkConv`` fed the action encoding as
(B, h, w, D) planes; latents are NHWC.

``SampledEfficientZeroModel`` (``models/sampled_efficientzero.py``) shares the
representation, the prediction side and the projector (``SampledHeads``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from lightzero_tpu_torch.models.common import (
    DynamicsNetworkConv,
    MLPTorso,
    PredictionNetworkConv,
    RepresentationNetworkConv,
    RepresentationNetworkMLP,
    SSLProjector,
    action_planes,
    conv_latent_shape,
)


class SampledNetworkOutput(NamedTuple):
    """Raw head outputs; the policy applies the inverse scalar transform.
    ``mu`` and ``sigma`` are set for a continuous action space,
    ``policy_logits`` for a discrete one."""

    value_logits: torch.Tensor  # (B, value_support)
    reward_logits: torch.Tensor  # (B, reward_support)
    latent_state: torch.Tensor  # (B, latent) or (B, h, w, C)
    mu: Optional[torch.Tensor] = None  # (B, D)
    sigma: Optional[torch.Tensor] = None  # (B, D)
    policy_logits: Optional[torch.Tensor] = None  # (B, A)


class SampledHeads(nn.Module):
    """The representation network, the prediction side and the SSL projector
    of both sampled models (flax ``_repr``, ``_common``, ``_value_head``,
    ``_mu_head``/``_sigma_head`` or ``_policy_head``, ``_proj``; conv:
    ``_repr``, ``_pred``, ``_proj``)."""

    def __init__(
        self,
        observation_shape: Any,
        action_space_size: int,
        continuous_action_space: bool,
        latent_state_dim: int,
        value_support_size: int,
        common_layer_num: int,
        norm_type: str,
        last_linear_layer_init_zero: bool,
        sigma_min: float,
        sigma_max: float,
        sigma_type: str,
        fixed_sigma_value: float,
        bound_mu: bool,
        model_type: str,
        num_channels: int,
        num_res_blocks: int,
        downsample: bool,
        generator: Optional[torch.Generator],
    ):
        super().__init__()
        L = latent_state_dim
        self.model_type = model_type
        self.action_space_size = action_space_size
        self.continuous_action_space = continuous_action_space
        self.sigma_min, self.sigma_max = float(sigma_min), float(sigma_max)
        self.sigma_type = sigma_type
        self.fixed_sigma_value = float(fixed_sigma_value)
        self.bound_mu = bound_mu
        if model_type == "conv":
            h, w, C = self.latent_shape = conv_latent_shape(observation_shape, num_channels,
                                                            downsample)
            self.representation_network = RepresentationNetworkConv(
                int(observation_shape[2]), num_channels, num_res_blocks, downsample, generator)
            self.prediction_network = PredictionNetworkConv(
                2 * action_space_size if continuous_action_space else action_space_size,
                num_channels, h * w, value_support_size=value_support_size,
                num_res_blocks=num_res_blocks, norm_type=norm_type,
                last_linear_layer_init_zero=last_linear_layer_init_zero, generator=generator)
            self.projector = SSLProjector(h * w * C, generator=generator)
            return
        if model_type != "mlp":
            raise ValueError(f"unknown model_type {model_type!r}")
        self.representation_network = RepresentationNetworkMLP(int(observation_shape), L, norm_type,
                                                               generator=generator)
        self.prediction_torso = MLPTorso(L, (L,) * (common_layer_num - 1), L, norm_type=norm_type,
                                         output_norm=True, output_activation=True,
                                         generator=generator)

        def head(width: int) -> MLPTorso:
            return MLPTorso(L, (32,), width, norm_type=norm_type,
                            last_linear_layer_init_zero=last_linear_layer_init_zero,
                            generator=generator)

        self.value_head = head(value_support_size)
        if continuous_action_space:
            self.mu_head = head(action_space_size)
            self.sigma_head = head(action_space_size)
        else:
            self.policy_head = head(action_space_size)
        self.projector = SSLProjector(L, generator=generator)

    def representation(self, obs: torch.Tensor) -> torch.Tensor:
        return self.representation_network(obs)

    def _mu_sigma(self, mu_raw: torch.Tensor, sigma_raw: torch.Tensor):
        mu = 1.5 * torch.tanh(mu_raw) if self.bound_mu else mu_raw
        if self.sigma_type == "fixed":
            sigma = torch.full_like(mu, self.fixed_sigma_value)
        else:
            sigma = self.sigma_min + (self.sigma_max - self.sigma_min) * torch.sigmoid(sigma_raw)
        return mu, sigma

    def prediction(self, latent: torch.Tensor):
        """-> (value_logits, mu, sigma) continuous, (value_logits, logits)
        discrete."""
        if self.model_type == "conv":
            value_logits, ms = self.prediction_network(latent)
            if not self.continuous_action_space:
                return value_logits, ms
            return (value_logits, *self._mu_sigma(*ms.chunk(2, dim=-1)))
        x = self.prediction_torso(latent)
        value_logits = self.value_head(x)
        if not self.continuous_action_space:
            return value_logits, self.policy_head(x)
        return (value_logits, *self._mu_sigma(self.mu_head(x), self.sigma_head(x)))

    def _policy_out(self, pred) -> dict:
        if self.continuous_action_space:
            return dict(mu=pred[1], sigma=pred[2])
        return dict(policy_logits=pred[1])

    def action_encoding(self, action: torch.Tensor) -> torch.Tensor:
        """Continuous: the raw (B, D) action. Discrete: the one-hot of the
        (B,) action indices."""
        if self.continuous_action_space:
            return action
        idx = action.long().reshape(action.shape[0])
        return nn.functional.one_hot(idx, self.action_space_size).to(torch.float32)

    def project(self, latent: torch.Tensor, with_grad: bool = True) -> torch.Tensor:
        return self.projector(latent, with_grad)


def sampled_model_kwargs(model_cfg: Any) -> dict:
    """The constructor arguments that both flax ``from_config``s read."""
    obs_shape = model_cfg.get("observation_shape", 3)
    default_type = "conv" if isinstance(obs_shape, (list, tuple)) else "mlp"
    kwargs = dict(
        observation_shape=tuple(obs_shape) if isinstance(obs_shape, list) else obs_shape,
        action_space_size=model_cfg.get("action_space_size", 1),
        continuous_action_space=model_cfg.get("continuous_action_space", True),
        latent_state_dim=model_cfg.get("latent_state_dim", 128),
        norm_type=model_cfg.get("norm_type", "LN"),
        model_type=model_cfg.get("model_type", default_type),
    )
    for k in ("value_support_size", "reward_support_size", "sigma_min", "sigma_max",
              "sigma_type", "fixed_sigma_value", "bound_mu", "num_channels",
              "num_res_blocks", "downsample"):
        if k in model_cfg:
            kwargs[k] = model_cfg[k]
    return kwargs


class SampledMuZeroModel(SampledHeads):
    def __init__(
        self,
        observation_shape: Any = 3,
        action_space_size: int = 1,
        continuous_action_space: bool = True,
        latent_state_dim: int = 128,
        value_support_size: int = 601,
        reward_support_size: int = 601,
        common_layer_num: int = 2,
        norm_type: str = "LN",
        last_linear_layer_init_zero: bool = True,
        sigma_min: float = 0.1,
        sigma_max: float = 2.0,
        sigma_type: str = "conditioned",
        fixed_sigma_value: float = 0.3,
        bound_mu: bool = True,
        model_type: str = "mlp",
        num_channels: int = 64,
        num_res_blocks: int = 1,
        downsample: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(observation_shape, action_space_size, continuous_action_space,
                         latent_state_dim, value_support_size, common_layer_num, norm_type,
                         last_linear_layer_init_zero, sigma_min, sigma_max, sigma_type,
                         fixed_sigma_value, bound_mu, model_type, num_channels, num_res_blocks,
                         downsample, generator)
        L = latent_state_dim
        self.reward_support_size = reward_support_size
        if model_type == "conv":
            h, w, _ = self.latent_shape
            self.dynamics_network = DynamicsNetworkConv(
                num_channels, action_space_size, h * w, num_res_blocks,
                reward_support_size=reward_support_size, norm_type=norm_type,
                last_linear_layer_init_zero=last_linear_layer_init_zero, generator=generator)
            return
        self.dynamics_torso = MLPTorso(L + action_space_size, (L,) * (common_layer_num - 1), L,
                                       norm_type=norm_type, output_norm=True,
                                       output_activation=True, generator=generator)
        self.reward_head = MLPTorso(L, (32,), reward_support_size, norm_type=norm_type,
                                    last_linear_layer_init_zero=last_linear_layer_init_zero,
                                    generator=generator)

    def dynamics(self, latent: torch.Tensor, action: torch.Tensor):
        """action: (B, D) floats in [-1, 1], or (B,) ints when discrete ->
        (next_latent, reward_logits)."""
        if self.model_type == "conv":
            return self.dynamics_network(latent, action_planes(self.action_encoding(action), latent))
        x = torch.cat([latent, self.action_encoding(action).to(latent.dtype)], dim=-1)
        next_latent = self.dynamics_torso(x)
        return next_latent, self.reward_head(next_latent)

    def initial_inference(self, obs: torch.Tensor) -> SampledNetworkOutput:
        """The reward at the root is a zero pad."""
        latent = self.representation(obs)
        pred = self.prediction(latent)
        zeros = torch.zeros((latent.shape[0], self.reward_support_size), dtype=pred[0].dtype,
                            device=latent.device)
        return SampledNetworkOutput(pred[0], zeros, latent, **self._policy_out(pred))

    def recurrent_inference(self, latent: torch.Tensor, action: torch.Tensor) -> SampledNetworkOutput:
        next_latent, reward_logits = self.dynamics(latent, action)
        pred = self.prediction(next_latent)
        return SampledNetworkOutput(pred[0], reward_logits, next_latent, **self._policy_out(pred))

    @staticmethod
    def from_config(model_cfg: Any, generator: Optional[torch.Generator] = None
                    ) -> "SampledMuZeroModel":
        """Build from a ``cfg.policy.model`` tree, reading the keys the flax
        ``from_config`` reads."""
        return SampledMuZeroModel(generator=generator, **sampled_model_kwargs(model_cfg))
