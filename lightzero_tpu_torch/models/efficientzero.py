"""EfficientZero model (``lightzero_tpu/models/efficientzero.py:39``): the
MuZero representation and prediction networks, a dynamics transition for
the next latent, and an LSTM whose output predicts the value prefix (the
discounted reward sum since the last horizon reset) instead of a per-step
reward.

``model_type`` 'mlp': the transition is a torso over latent ⊕ one-hot
action and the LSTM reads the next latent. 'conv' (:86-113, :141-166): NHWC
latents (B, h, w, C), the transition ``conv_transition`` over the latent and
one-hot action planes, and the LSTM reads a 1x1-conv reduction of the next
latent to 16 channels (LayerNorm, relu), flattened in (h, w, c) order.

The LSTM is torch's ``nn.LSTMCell`` in place of flax's
``OptimizedLSTMCell``. The flax cell has one bias per gate, on the hidden
side; so here ``bias_ih`` is a zero buffer, not a parameter, and the
parameters are exactly flax's (``utils/params_import.py`` maps them). The
recurrent state is ``(c, h)`` in flax's order throughout the model's API and
the search embedding; torch's cell takes and returns ``(h, c)``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

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
    SSLProjector,
    action_planes,
    conv_latent_shape,
    conv_reduce,
    conv_transition,
    lecun_normal_,
)

# channels of the 1x1 reduction the conv branch's LSTM reads (flax _vp_reduce)
VALUE_PREFIX_REDUCE_CHANNELS = 16


class EZNetworkOutput(NamedTuple):
    """Raw head outputs; the policy applies the inverse scalar transform."""

    value_logits: torch.Tensor  # (B, value_support)
    value_prefix_logits: torch.Tensor  # (B, reward_support)
    policy_logits: torch.Tensor  # (B, A)
    latent_state: torch.Tensor  # (B, latent) or (B, h, w, C)
    reward_hidden: Tuple[torch.Tensor, torch.Tensor]  # (c, h), each (B, lstm_hidden)


def flax_lstm_cell(in_dim: int, hidden: int, generator: Optional[torch.Generator]) -> nn.LSTMCell:
    """``nn.LSTMCell`` with flax ``OptimizedLSTMCell``'s parameters and init:
    input kernels lecun-normal, hidden kernels orthogonal (per gate), the
    hidden-side bias zero, and no input-side bias (a zero buffer)."""
    cell = nn.LSTMCell(in_dim, hidden)
    del cell.bias_ih
    cell.register_buffer("bias_ih", torch.zeros(4 * hidden))
    with torch.no_grad():
        for gate in range(4):
            rows = slice(gate * hidden, (gate + 1) * hidden)
            cell.weight_ih[rows] = lecun_normal_(torch.empty(hidden, in_dim), generator)
            cell.weight_hh[rows] = nn.init.orthogonal_(
                torch.empty(hidden, hidden), generator=generator
            )
        cell.bias_hh.zero_()
    return cell


def conv_value_prefix_stack(model: nn.Module, num_channels: int, num_res_blocks: int,
                            enc_channels: int, generator: Optional[torch.Generator]) -> None:
    """The conv transition and the value prefix's 1x1 reduction of both
    EfficientZero models, flax's ``_dyn_conv``, ``_dyn_norm``,
    ``_dyn_blocks``, ``_vp_reduce`` and ``_vp_reduce_norm``."""
    model.dynamics_conv = ConvNHWC(num_channels + enc_channels, num_channels,
                                   generator=generator)
    model.dynamics_norm = nn.LayerNorm(num_channels, eps=LAYER_NORM_EPS)
    model.dynamics_blocks = nn.ModuleList(ResBlock(num_channels, generator)
                                          for _ in range(num_res_blocks))
    model.value_prefix_reduce = ConvNHWC(num_channels, VALUE_PREFIX_REDUCE_CHANNELS, 1,
                                         generator=generator)
    model.value_prefix_reduce_norm = nn.LayerNorm(VALUE_PREFIX_REDUCE_CHANNELS,
                                                  eps=LAYER_NORM_EPS)


def conv_value_prefix_step(model: nn.Module, latent: torch.Tensor, enc: torch.Tensor):
    """(latent, (B, E) action encoding) -> (next latent, the LSTM's input)
    through the stack ``conv_value_prefix_stack`` built."""
    next_latent = conv_transition(model.dynamics_conv, model.dynamics_norm,
                                  model.dynamics_blocks, latent, action_planes(enc, latent))
    return next_latent, conv_reduce(model.value_prefix_reduce, model.value_prefix_reduce_norm,
                                    next_latent)


class EfficientZeroModel(nn.Module):
    def __init__(
        self,
        observation_shape: Any = 4,
        action_space_size: int = 2,
        model_type: str = "mlp",
        latent_state_dim: int = 256,
        lstm_hidden_size: int = 512,
        value_support_size: int = 601,
        reward_support_size: int = 601,
        common_layer_num: int = 2,
        reward_head_hidden_channels: Sequence[int] = (32,),
        value_head_hidden_channels: Sequence[int] = (32,),
        policy_head_hidden_channels: Sequence[int] = (32,),
        num_channels: int = 64,
        num_res_blocks: int = 1,
        downsample: bool = True,
        norm_type: str = "LN",
        last_linear_layer_init_zero: bool = True,
        proj_hid: int = 1024,
        proj_out: int = 1024,
        pred_hid: int = 512,
        pred_out: int = 1024,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.action_space_size = action_space_size
        self.lstm_hidden_size = lstm_hidden_size
        self.reward_support_size = reward_support_size
        self.model_type = model_type
        if model_type == "mlp":
            self.representation_network = RepresentationNetworkMLP(
                int(observation_shape), latent_state_dim, norm_type, generator=generator
            )
            self.prediction_network = PredictionNetworkMLP(
                action_space_size,
                latent_state_dim,
                value_support_size=value_support_size,
                common_layer_num=common_layer_num,
                value_head_hidden_channels=value_head_hidden_channels,
                policy_head_hidden_channels=policy_head_hidden_channels,
                norm_type=norm_type,
                last_linear_layer_init_zero=last_linear_layer_init_zero,
                generator=generator,
            )
            # the state transition; the reward side is the LSTM below
            self.dynamics_torso = MLPTorso(
                latent_state_dim + action_space_size,
                (latent_state_dim,) * (common_layer_num - 1),
                latent_state_dim,
                norm_type=norm_type,
                output_norm=True,
                output_activation=True,
                generator=generator,
            )
            lstm_in = proj_in = latent_state_dim
        elif model_type == "conv":
            h, w, c = self.latent_shape = conv_latent_shape(observation_shape, num_channels,
                                                            downsample)
            self.representation_network = RepresentationNetworkConv(
                int(observation_shape[2]), num_channels, num_res_blocks, downsample, generator
            )
            self.prediction_network = PredictionNetworkConv(
                action_space_size, num_channels, h * w,
                value_support_size=value_support_size,
                num_res_blocks=num_res_blocks,
                value_head_hidden_channels=value_head_hidden_channels,
                policy_head_hidden_channels=policy_head_hidden_channels,
                norm_type=norm_type,
                last_linear_layer_init_zero=last_linear_layer_init_zero,
                generator=generator,
            )
            conv_value_prefix_stack(self, num_channels, num_res_blocks, action_space_size,
                                    generator)
            lstm_in, proj_in = h * w * VALUE_PREFIX_REDUCE_CHANNELS, h * w * c
        else:
            raise ValueError(f"unknown model_type {model_type!r}")
        self.lstm = flax_lstm_cell(lstm_in, lstm_hidden_size, generator)
        # a bare flax LayerNorm: eps 1e-6 (torch's default is 1e-5)
        self.value_prefix_norm = nn.LayerNorm(lstm_hidden_size, eps=LAYER_NORM_EPS)
        self.value_prefix_head = MLPTorso(
            lstm_hidden_size,
            tuple(reward_head_hidden_channels),
            reward_support_size,
            norm_type=norm_type,
            last_linear_layer_init_zero=last_linear_layer_init_zero,
            generator=generator,
        )
        # the flax model always has the projector (its __call__ builds it)
        self.projector = SSLProjector(
            proj_in, proj_hid, proj_out, pred_hid, pred_out, generator
        )

    def representation(self, obs: torch.Tensor) -> torch.Tensor:
        return self.representation_network(obs)

    def prediction(self, latent: torch.Tensor):
        return self.prediction_network(latent)

    def init_reward_hidden(self, batch_size: int, device=None, dtype=torch.float32):
        z = torch.zeros((batch_size, self.lstm_hidden_size), dtype=dtype, device=device)
        return (z, z)

    def dynamics(self, latent: torch.Tensor, reward_hidden, action: torch.Tensor):
        """-> (next_latent, (c', h'), value_prefix_logits)."""
        enc = nn.functional.one_hot(action.long(), self.action_space_size).to(latent.dtype)
        if self.model_type == "conv":
            next_latent, lstm_in = conv_value_prefix_step(self, latent, enc)
        else:
            next_latent = lstm_in = self.dynamics_torso(torch.cat([latent, enc], dim=-1))
        c, h = reward_hidden
        h_new, c_new = self.lstm(lstm_in, (h, c))
        vp = torch.relu(self.value_prefix_norm(h_new))
        return next_latent, (c_new, h_new), self.value_prefix_head(vp)

    def initial_inference(self, obs: torch.Tensor) -> EZNetworkOutput:
        """The value prefix at the root is a zero pad, the LSTM state zero."""
        latent = self.representation(obs)
        value_logits, policy_logits = self.prediction(latent)
        B = latent.shape[0]
        return EZNetworkOutput(
            value_logits=value_logits,
            value_prefix_logits=torch.zeros(
                (B, self.reward_support_size), dtype=value_logits.dtype, device=latent.device
            ),
            policy_logits=policy_logits,
            latent_state=latent,
            reward_hidden=self.init_reward_hidden(B, latent.device, latent.dtype),
        )

    def recurrent_inference(self, latent: torch.Tensor, reward_hidden, action: torch.Tensor
                            ) -> EZNetworkOutput:
        next_latent, carry, value_prefix_logits = self.dynamics(latent, reward_hidden, action)
        value_logits, policy_logits = self.prediction(next_latent)
        return EZNetworkOutput(
            value_logits=value_logits,
            value_prefix_logits=value_prefix_logits,
            policy_logits=policy_logits,
            latent_state=next_latent,
            reward_hidden=carry,
        )

    def project(self, latent: torch.Tensor, with_grad: bool = True) -> torch.Tensor:
        """SSL projection (flax ``EfficientZeroModel.project``)."""
        return self.projector(latent, with_grad)

    @staticmethod
    def from_config(model_cfg: Any, generator: Optional[torch.Generator] = None
                    ) -> "EfficientZeroModel":
        """Build from a ``cfg.policy.model`` tree, reading the keys the flax
        ``from_config`` reads (the projector keeps its default widths)."""
        obs_shape = model_cfg.get("observation_shape", 4)
        kwargs = dict(
            observation_shape=tuple(obs_shape) if isinstance(obs_shape, list) else obs_shape,
            action_space_size=model_cfg.get("action_space_size", 2),
            model_type=model_cfg.get("model_type", "mlp"),
            latent_state_dim=model_cfg.get("latent_state_dim", 256),
            lstm_hidden_size=model_cfg.get("lstm_hidden_size", 512),
            norm_type=model_cfg.get("norm_type", "LN"),
            num_channels=model_cfg.get("num_channels", 64),
            num_res_blocks=model_cfg.get("num_res_blocks", 1),
            downsample=model_cfg.get("downsample", True),
        )
        for k in ("value_support_size", "reward_support_size"):
            if k in model_cfg:
                kwargs[k] = model_cfg[k]
        return EfficientZeroModel(generator=generator, **kwargs)
