"""Stochastic MuZero model (``lightzero_tpu/models/stochastic_muzero.py:35-269``):
MuZero's representation and prediction networks, plus

- ``afterstate_dynamics``: latent ⊕ one-hot action -> afterstate, an
  ``MLPTorso`` with its output normalised and activated;
- ``afterstate_prediction``: afterstate -> (value logits, chance logits), a
  prediction network whose policy head is ``chance_space_size`` wide;
- ``dynamics``: afterstate ⊕ one-hot chance -> (next latent, reward
  logits), the reward head an ``MLPTorso((32,))`` on the next latent;
- ``chance_encode``: a pair of consecutive observations -> (chance logits,
  straight-through one-hot ``soft + (onehot - soft).detach()``).

``recurrent_inference(latent, action, afterstate)`` is a decision step
(latent, action -> afterstate, chance logits, afterstate value; a zero
reward) when ``afterstate`` is False and a chance step (afterstate, chance
-> latent, reward, value, policy) when it is True.

``model_type='conv'`` (:56-107, :157-205) keeps the same API on NHWC
latents: both transitions are ``conv_transition`` over one-hot action or
chance planes, the reward head reads a 1x1-conv reduction of the next
latent to 16 channels, and the chance encoder is a stride-2 SAME conv
(flax's default padding, (0, 1) on an even size), LayerNorm and relu over
the observation pair stacked on the channel axis, (B, H, W, 2 C), then an
``MLPTorso((latent_state_dim,))``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from lightzero_tpu_torch.models.common import (
    LAYER_NORM_EPS,
    ConvNHWC,
    MLPTorso,
    PredictionNetworkConv,
    PredictionNetworkMLP,
    RepresentationNetworkConv,
    RepresentationNetworkMLP,
    ResBlock,
    action_planes,
    conv_latent_shape,
    conv_out_size,
    conv_reduce,
    conv_transition,
)

# channels of the 1x1 reduction the conv reward head reads (flax _reward_reduce)
REWARD_REDUCE_CHANNELS = 16


class StochasticMZOutput(NamedTuple):
    """Raw head outputs; the policy applies the inverse scalar transform."""

    value_logits: torch.Tensor  # (B, value_support)
    reward_logits: torch.Tensor  # (B, reward_support)
    policy_logits: torch.Tensor  # (B, A) after a chance step, (B, C) after a decision step
    latent_state: torch.Tensor  # (B, latent) or (B, h, w, C)


class StochasticMuZeroModel(nn.Module):
    def __init__(
        self,
        observation_shape: Any = 256,
        action_space_size: int = 4,
        chance_space_size: int = 32,
        latent_state_dim: int = 256,
        value_support_size: int = 601,
        reward_support_size: int = 601,
        common_layer_num: int = 2,
        norm_type: str = "LN",
        last_linear_layer_init_zero: bool = True,
        model_type: str = "mlp",
        num_channels: int = 64,
        num_res_blocks: int = 1,
        downsample: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        L = latent_state_dim
        self.action_space_size = action_space_size
        self.chance_space_size = chance_space_size
        self.reward_support_size = reward_support_size
        self.model_type = model_type
        if model_type == "conv":
            self._init_conv(observation_shape, value_support_size, norm_type,
                            last_linear_layer_init_zero, L, num_channels, num_res_blocks,
                            downsample, generator)
            return
        if model_type != "mlp":
            raise ValueError(f"unknown model_type {model_type!r}")
        obs_dim = int(observation_shape)
        self.representation_network = RepresentationNetworkMLP(obs_dim, L, norm_type,
                                                               generator=generator)
        self.prediction_network = PredictionNetworkMLP(
            action_space_size, L, value_support_size=value_support_size,
            common_layer_num=common_layer_num, norm_type=norm_type,
            last_linear_layer_init_zero=last_linear_layer_init_zero, generator=generator,
        )
        self.afterstate_prediction_network = PredictionNetworkMLP(
            chance_space_size, L, value_support_size=value_support_size,
            common_layer_num=common_layer_num, norm_type=norm_type,
            last_linear_layer_init_zero=last_linear_layer_init_zero, generator=generator,
        )

        def transition(enc_dim: int) -> MLPTorso:
            return MLPTorso(L + enc_dim, (L,) * (common_layer_num - 1), L, norm_type=norm_type,
                            output_norm=True, output_activation=True, generator=generator)

        self.afterstate_dynamics_network = transition(action_space_size)
        self.dynamics_network = transition(chance_space_size)
        self.reward_head = MLPTorso(
            L, (32,), reward_support_size, norm_type=norm_type,
            last_linear_layer_init_zero=last_linear_layer_init_zero, generator=generator,
        )
        self.chance_encoder = MLPTorso(2 * obs_dim, (L,), chance_space_size, norm_type=norm_type,
                                       generator=generator)

    def _init_conv(self, observation_shape, value_support_size, norm_type,
                   last_linear_layer_init_zero, L, num_channels, num_res_blocks, downsample,
                   generator) -> None:
        """The conv branch's modules, named after flax's: ``_repr``,
        ``_pred``, ``_afterstate_pred``, ``_as_dyn_{conv,norm,blocks}``,
        ``_dyn_{conv,norm,blocks}``, ``_reward_reduce{,_norm}``,
        ``_reward_head``, ``_chance_{conv,norm,head}``."""
        H, W, c_in = (int(n) for n in observation_shape)
        h, w, C = self.latent_shape = conv_latent_shape(observation_shape, num_channels,
                                                        downsample)
        self.representation_network = RepresentationNetworkConv(
            c_in, num_channels, num_res_blocks, downsample, generator)

        def prediction(width: int) -> PredictionNetworkConv:
            return PredictionNetworkConv(
                width, num_channels, h * w, value_support_size=value_support_size,
                num_res_blocks=num_res_blocks, norm_type=norm_type,
                last_linear_layer_init_zero=last_linear_layer_init_zero, generator=generator)

        self.prediction_network = prediction(self.action_space_size)
        self.afterstate_prediction_network = prediction(self.chance_space_size)
        for prefix, enc in (("afterstate_dynamics", self.action_space_size),
                            ("dynamics", self.chance_space_size)):
            setattr(self, f"{prefix}_conv", ConvNHWC(C + enc, C, generator=generator))
            setattr(self, f"{prefix}_norm", nn.LayerNorm(C, eps=LAYER_NORM_EPS))
            setattr(self, f"{prefix}_blocks", nn.ModuleList(
                ResBlock(C, generator) for _ in range(num_res_blocks)))
        self.reward_reduce = ConvNHWC(C, REWARD_REDUCE_CHANNELS, 1, generator=generator)
        self.reward_reduce_norm = nn.LayerNorm(REWARD_REDUCE_CHANNELS, eps=LAYER_NORM_EPS)
        self.reward_head = MLPTorso(
            h * w * REWARD_REDUCE_CHANNELS, (32,), self.reward_support_size,
            norm_type=norm_type, last_linear_layer_init_zero=last_linear_layer_init_zero,
            generator=generator)
        self.chance_conv = ConvNHWC(2 * c_in, C, 3, 2, generator)
        self.chance_norm = nn.LayerNorm(C, eps=LAYER_NORM_EPS)
        chance_hw = conv_out_size(H, 3, 2) * conv_out_size(W, 3, 2)
        self.chance_head = MLPTorso(chance_hw * C, (L,), self.chance_space_size,
                                    norm_type=norm_type, generator=generator)

    def representation(self, obs: torch.Tensor) -> torch.Tensor:
        return self.representation_network(obs)

    def prediction(self, latent: torch.Tensor):
        return self.prediction_network(latent)

    def afterstate_dynamics(self, latent: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        enc = nn.functional.one_hot(action.long(), self.action_space_size).to(latent.dtype)
        if self.model_type == "conv":
            return conv_transition(self.afterstate_dynamics_conv, self.afterstate_dynamics_norm,
                                   self.afterstate_dynamics_blocks, latent,
                                   action_planes(enc, latent))
        return self.afterstate_dynamics_network(torch.cat([latent, enc], dim=-1))

    def afterstate_prediction(self, afterstate: torch.Tensor):
        """-> (value_logits, chance_logits)."""
        return self.afterstate_prediction_network(afterstate)

    def dynamics(self, afterstate: torch.Tensor, chance: torch.Tensor):
        """-> (next_latent, reward_logits)."""
        enc = nn.functional.one_hot(chance.long(), self.chance_space_size).to(afterstate.dtype)
        if self.model_type == "conv":
            next_latent = conv_transition(self.dynamics_conv, self.dynamics_norm,
                                          self.dynamics_blocks, afterstate,
                                          action_planes(enc, afterstate))
            return next_latent, self.reward_head(
                conv_reduce(self.reward_reduce, self.reward_reduce_norm, next_latent))
        next_latent = self.dynamics_network(torch.cat([afterstate, enc], dim=-1))
        return next_latent, self.reward_head(next_latent)

    def chance_encode(self, obs_pair: torch.Tensor):
        """Consecutive observations, (B, 2 obs_dim) or, conv, (B, H, W, 2 C)
        -> (logits, the straight-through one-hot of their argmax)."""
        if self.model_type == "conv":
            x = torch.relu(self.chance_norm(self.chance_conv(obs_pair)))
            logits = self.chance_head(x.reshape(x.shape[0], -1))
        else:
            logits = self.chance_encoder(obs_pair)
        onehot = nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                       self.chance_space_size).to(logits.dtype)
        soft = torch.softmax(logits, dim=-1)
        return logits, soft + (onehot - soft).detach()

    def initial_inference(self, obs: torch.Tensor) -> StochasticMZOutput:
        """The reward at the root is a zero pad."""
        latent = self.representation(obs)
        value_logits, policy_logits = self.prediction(latent)
        return StochasticMZOutput(
            value_logits=value_logits,
            reward_logits=torch.zeros((latent.shape[0], self.reward_support_size),
                                      dtype=value_logits.dtype, device=latent.device),
            policy_logits=policy_logits,
            latent_state=latent,
        )

    def recurrent_inference(self, latent: torch.Tensor, action: torch.Tensor,
                            afterstate: bool = False) -> StochasticMZOutput:
        if afterstate:
            next_latent, reward_logits = self.dynamics(latent, action)
            value_logits, policy_logits = self.prediction(next_latent)
            return StochasticMZOutput(value_logits, reward_logits, policy_logits, next_latent)
        as_latent = self.afterstate_dynamics(latent, action)
        value_logits, chance_logits = self.afterstate_prediction(as_latent)
        return StochasticMZOutput(
            value_logits,
            torch.zeros((latent.shape[0], self.reward_support_size), dtype=value_logits.dtype,
                        device=latent.device),
            chance_logits,
            as_latent,
        )

    @staticmethod
    def from_config(model_cfg: Any, generator: Optional[torch.Generator] = None
                    ) -> "StochasticMuZeroModel":
        """Build from a ``cfg.policy.model`` tree, reading the keys the flax
        ``from_config`` reads."""
        obs_shape = model_cfg.get("observation_shape", 256)
        default_type = "conv" if isinstance(obs_shape, (list, tuple)) else "mlp"
        kwargs = dict(
            observation_shape=tuple(obs_shape) if isinstance(obs_shape, list) else obs_shape,
            action_space_size=model_cfg.get("action_space_size", 4),
            chance_space_size=model_cfg.get("chance_space_size", 32),
            latent_state_dim=model_cfg.get("latent_state_dim", 256),
            norm_type=model_cfg.get("norm_type", "LN"),
            model_type=model_cfg.get("model_type", default_type),
        )
        for k in ("value_support_size", "reward_support_size", "num_channels",
                  "num_res_blocks", "downsample"):
            if k in model_cfg:
                kwargs[k] = model_cfg[k]
        return StochasticMuZeroModel(generator=generator, **kwargs)
