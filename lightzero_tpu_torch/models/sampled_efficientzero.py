"""Sampled EfficientZero model
(``lightzero_tpu/models/sampled_efficientzero.py:27-286``): the Sampled MuZero
representation, prediction side (Gaussian or logits policy) and projector
(``SampledHeads``) over EfficientZero's dynamics: latent ⊕ action encoding
-> next latent, then an LSTM over the next latent whose output, normalised
and activated, predicts the value prefix.

The LSTM is built as ``models/efficientzero.py`` builds it: ``nn.LSTMCell``
with flax ``OptimizedLSTMCell``'s parameters (``bias_ih`` a zero buffer),
its state ``(c, h)`` in flax's order.

``model_type='conv'`` (:71-90, :167-210): the conv ``SampledHeads``, and
EfficientZero's conv dynamics (``models/efficientzero.py``'s
``conv_value_prefix_stack``) fed the action encoding as (B, h, w, D) planes,
the LSTM reading the 16-channel 1x1 reduction flattened in (h, w, c) order.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import nn

from lightzero_tpu_torch.models.common import LAYER_NORM_EPS, MLPTorso
from lightzero_tpu_torch.models.efficientzero import (
    VALUE_PREFIX_REDUCE_CHANNELS,
    conv_value_prefix_stack,
    conv_value_prefix_step,
    flax_lstm_cell,
)
from lightzero_tpu_torch.models.sampled_muzero import SampledHeads, sampled_model_kwargs


class SampledEZOutput(NamedTuple):
    """Raw head outputs; the policy applies the inverse scalar transform.
    ``mu`` and ``sigma`` are set for a continuous action space,
    ``policy_logits`` for a discrete one."""

    value_logits: torch.Tensor  # (B, value_support)
    value_prefix_logits: torch.Tensor  # (B, reward_support)
    latent_state: torch.Tensor  # (B, latent) or (B, h, w, C)
    reward_hidden: Tuple[torch.Tensor, torch.Tensor]  # (c, h), each (B, lstm_hidden)
    mu: Optional[torch.Tensor] = None
    sigma: Optional[torch.Tensor] = None
    policy_logits: Optional[torch.Tensor] = None


class SampledEfficientZeroModel(SampledHeads):
    def __init__(
        self,
        observation_shape: Any = 3,
        action_space_size: int = 1,
        continuous_action_space: bool = True,
        latent_state_dim: int = 128,
        lstm_hidden_size: int = 256,
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
        self.lstm_hidden_size = lstm_hidden_size
        self.reward_support_size = reward_support_size
        if model_type == "conv":
            h, w, _ = self.latent_shape
            conv_value_prefix_stack(self, num_channels, num_res_blocks, action_space_size,
                                    generator)
            lstm_in = h * w * VALUE_PREFIX_REDUCE_CHANNELS
        else:
            self.dynamics_torso = MLPTorso(L + action_space_size, (L,) * (common_layer_num - 1),
                                           L, norm_type=norm_type, output_norm=True,
                                           output_activation=True, generator=generator)
            lstm_in = L
        self.lstm = flax_lstm_cell(lstm_in, lstm_hidden_size, generator)
        self.value_prefix_norm = nn.LayerNorm(lstm_hidden_size, eps=LAYER_NORM_EPS)
        self.value_prefix_head = MLPTorso(
            lstm_hidden_size, (32,), reward_support_size, norm_type=norm_type,
            last_linear_layer_init_zero=last_linear_layer_init_zero, generator=generator,
        )

    def init_reward_hidden(self, batch_size: int, device=None, dtype=torch.float32):
        z = torch.zeros((batch_size, self.lstm_hidden_size), dtype=dtype, device=device)
        return (z, z)

    def dynamics(self, latent: torch.Tensor, reward_hidden, action: torch.Tensor):
        """-> (next_latent, (c', h'), value_prefix_logits)."""
        enc = self.action_encoding(action).to(latent.dtype)
        if self.model_type == "conv":
            next_latent, lstm_in = conv_value_prefix_step(self, latent, enc)
        else:
            next_latent = lstm_in = self.dynamics_torso(torch.cat([latent, enc], dim=-1))
        c, h = reward_hidden
        h_new, c_new = self.lstm(lstm_in, (h, c))
        vp = torch.relu(self.value_prefix_norm(h_new))
        return next_latent, (c_new, h_new), self.value_prefix_head(vp)

    def initial_inference(self, obs: torch.Tensor) -> SampledEZOutput:
        """The value prefix at the root is a zero pad, the LSTM state zero."""
        latent = self.representation(obs)
        pred = self.prediction(latent)
        B = latent.shape[0]
        zeros = torch.zeros((B, self.reward_support_size), dtype=pred[0].dtype,
                            device=latent.device)
        return SampledEZOutput(pred[0], zeros, latent,
                               self.init_reward_hidden(B, latent.device, latent.dtype),
                               **self._policy_out(pred))

    def recurrent_inference(self, latent: torch.Tensor, reward_hidden, action: torch.Tensor
                            ) -> SampledEZOutput:
        next_latent, carry, value_prefix_logits = self.dynamics(latent, reward_hidden, action)
        pred = self.prediction(next_latent)
        return SampledEZOutput(pred[0], value_prefix_logits, next_latent, carry,
                               **self._policy_out(pred))

    @staticmethod
    def from_config(model_cfg: Any, generator: Optional[torch.Generator] = None
                    ) -> "SampledEfficientZeroModel":
        """Build from a ``cfg.policy.model`` tree, reading the keys the flax
        ``from_config`` reads."""
        kwargs = sampled_model_kwargs(model_cfg)
        kwargs["lstm_hidden_size"] = model_cfg.get("lstm_hidden_size", 256)
        return SampledEfficientZeroModel(generator=generator, **kwargs)
