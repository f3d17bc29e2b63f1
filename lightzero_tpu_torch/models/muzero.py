"""MuZero model (``lightzero_tpu/models/muzero.py:31``): representation +
dynamics + prediction, and the SSL projector when
``self_supervised_learning_loss`` is set, with ``model_type`` 'mlp' (flat
observations) or 'conv' (NHWC image observations (H, W, C); latents
(B, h, w, C); the action enters the dynamics as one-hot planes, or one plane
of a / A under 'not_one_hot'; the projector reads the latent flattened in
(h, w, c) order).

With ``num_tasks`` > 0 (the multitask policy, ``muzero_model_multitask``'s
role) a learned task embedding is added to the root latent: a feature add
under 'mlp' (width ``latent_state_dim``), a per-channel bias over the grid
under 'conv' (width ``num_channels``). Only ``representation`` and
``initial_inference`` take the task id; the dynamics carry the conditioning
forward from the root. A task id of None skips it.

With ``harmony_balance`` the model holds HarmonyDream's three learnable
loss weights, ``harmony_policy``, ``harmony_value`` and ``harmony_reward``:
0-d parameters that start at zero (flax's top-level params of those names),
which the policy's loss reads (``policy/muzero.py``).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from lightzero_tpu_torch.models.common import (
    DynamicsNetworkConv,
    DynamicsNetworkMLP,
    NetworkOutput,
    PredictionNetworkConv,
    PredictionNetworkMLP,
    RepresentationNetworkConv,
    RepresentationNetworkMLP,
    SSLProjector,
    action_planes,
    conv_latent_shape,
)


class MuZeroModel(nn.Module):
    def __init__(
        self,
        observation_shape: Any = 4,
        action_space_size: int = 2,
        model_type: str = "mlp",
        latent_state_dim: int = 256,
        value_support_size: int = 601,
        reward_support_size: int = 601,
        common_layer_num: int = 2,
        reward_head_hidden_channels: Sequence[int] = (32,),
        value_head_hidden_channels: Sequence[int] = (32,),
        policy_head_hidden_channels: Sequence[int] = (32,),
        res_connection_in_dynamics: bool = False,
        num_channels: int = 64,
        num_res_blocks: int = 1,
        downsample: bool = True,
        norm_type: str = "LN",
        last_linear_layer_init_zero: bool = True,
        discrete_action_encoding_type: str = "one_hot",
        self_supervised_learning_loss: bool = False,
        proj_hid: int = 1024,
        proj_out: int = 1024,
        pred_hid: int = 512,
        pred_out: int = 1024,
        num_tasks: int = 0,
        harmony_balance: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.action_space_size = action_space_size
        self.model_type = model_type
        self.latent_state_dim = latent_state_dim
        self.reward_support_size = reward_support_size
        self.discrete_action_encoding_type = discrete_action_encoding_type
        enc_dim = action_space_size if discrete_action_encoding_type == "one_hot" else 1
        if model_type == "mlp":
            self.representation_network = RepresentationNetworkMLP(
                int(observation_shape), latent_state_dim, norm_type, generator=generator
            )
            self.dynamics_network = DynamicsNetworkMLP(
                enc_dim,
                latent_state_dim=latent_state_dim,
                reward_support_size=reward_support_size,
                common_layer_num=common_layer_num,
                reward_head_hidden_channels=reward_head_hidden_channels,
                norm_type=norm_type,
                res_connection_in_dynamics=res_connection_in_dynamics,
                last_linear_layer_init_zero=last_linear_layer_init_zero,
                generator=generator,
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
            proj_in = latent_state_dim
        elif model_type == "conv":
            h, w, c = self.latent_shape = conv_latent_shape(observation_shape, num_channels,
                                                            downsample)
            self.representation_network = RepresentationNetworkConv(
                int(observation_shape[2]), num_channels, num_res_blocks, downsample, generator
            )
            self.dynamics_network = DynamicsNetworkConv(
                num_channels, enc_dim, h * w, num_res_blocks,
                reward_support_size=reward_support_size,
                reward_head_hidden_channels=reward_head_hidden_channels,
                norm_type=norm_type,
                last_linear_layer_init_zero=last_linear_layer_init_zero,
                generator=generator,
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
            proj_in = h * w * c
        else:
            raise ValueError(f"unknown model_type {model_type!r}")
        # as in flax, the projector exists only when the SSL loss is on
        self.projector = (
            SSLProjector(proj_in, proj_hid, proj_out, pred_hid, pred_out, generator)
            if self_supervised_learning_loss
            else None
        )
        self.num_tasks = num_tasks
        if num_tasks > 0:
            # flax nn.Embed's default init: normal with std 1 / sqrt(width)
            dim = latent_state_dim if model_type == "mlp" else num_channels
            self.task_embed = nn.Embedding(num_tasks, dim)
            with torch.no_grad():
                self.task_embed.weight.normal_(0.0, dim ** -0.5, generator=generator)
        self.harmony_balance = harmony_balance
        if harmony_balance:
            self.harmony_policy = nn.Parameter(torch.zeros(()))
            self.harmony_value = nn.Parameter(torch.zeros(()))
            self.harmony_reward = nn.Parameter(torch.zeros(()))

    def _encode_action(self, action: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, A) one-hot, or (B, 1) a / A under 'not_one_hot' (reference
        muzero_model_mlp.py:91); the conv dynamics read it as planes."""
        if self.discrete_action_encoding_type == "one_hot":
            return nn.functional.one_hot(action.long(), self.action_space_size).to(dtype)
        return (action.to(dtype) / self.action_space_size)[:, None]

    def _condition_on_task(self, latent: torch.Tensor,
                           task_id: Optional[torch.Tensor]) -> torch.Tensor:
        """The latent plus the task's embedding ((B, h, w, c) latents: a
        per-channel bias); the latent itself without a table or a task id."""
        if self.num_tasks == 0 or task_id is None:
            return latent
        e = self.task_embed(task_id.long())
        if latent.dim() == 4:
            e = e[:, None, None, :]
        return latent + e

    def representation(self, obs: torch.Tensor,
                       task_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._condition_on_task(self.representation_network(obs), task_id)

    def dynamics(self, latent: torch.Tensor, action: torch.Tensor):
        enc = self._encode_action(action, latent.dtype)
        if self.model_type == "conv":
            # one-hot planes, or one plane of a / A (flax _encode_action_conv)
            enc = action_planes(enc, latent)
        return self.dynamics_network(latent, enc)

    def prediction(self, latent: torch.Tensor):
        return self.prediction_network(latent)

    def initial_inference(self, obs: torch.Tensor,
                          task_id: Optional[torch.Tensor] = None) -> NetworkOutput:
        """The reward at the root is a zero pad. ``task_id`` (B,) conditions
        the root latent in multitask runs."""
        latent = self.representation(obs, task_id)
        value_logits, policy_logits = self.prediction(latent)
        return NetworkOutput(
            value_logits=value_logits,
            reward_logits=torch.zeros_like(value_logits[..., : self.reward_support_size]),
            policy_logits=policy_logits,
            latent_state=latent,
        )

    def recurrent_inference(self, latent: torch.Tensor, action: torch.Tensor) -> NetworkOutput:
        next_latent, reward_logits = self.dynamics(latent, action)
        value_logits, policy_logits = self.prediction(next_latent)
        return NetworkOutput(
            value_logits=value_logits,
            reward_logits=reward_logits,
            policy_logits=policy_logits,
            latent_state=next_latent,
        )

    def project(self, latent: torch.Tensor, with_grad: bool = True) -> torch.Tensor:
        """SSL projection (flax ``MuZeroModel.project``)."""
        return self.projector(latent, with_grad)

    @staticmethod
    def from_config(model_cfg: Any, generator: Optional[torch.Generator] = None) -> "MuZeroModel":
        """Build from a ``cfg.policy.model`` tree (the JAX package's key names)."""
        obs_shape = model_cfg.get("observation_shape", 4)
        kwargs = dict(
            observation_shape=tuple(obs_shape) if isinstance(obs_shape, list) else obs_shape,
            action_space_size=model_cfg.get("action_space_size", 2),
            model_type=model_cfg.get("model_type", "mlp"),
            latent_state_dim=model_cfg.get("latent_state_dim", 256),
            norm_type=model_cfg.get("norm_type", "LN"),
            discrete_action_encoding_type=model_cfg.get("discrete_action_encoding_type", "one_hot"),
            res_connection_in_dynamics=model_cfg.get("res_connection_in_dynamics", False),
            self_supervised_learning_loss=model_cfg.get("self_supervised_learning_loss", False),
            num_channels=model_cfg.get("num_channels", 64),
            num_res_blocks=model_cfg.get("num_res_blocks", 1),
            downsample=model_cfg.get("downsample", True),
            num_tasks=int(model_cfg.get("num_tasks", 0)),
            harmony_balance=bool(model_cfg.get("harmony_balance", False)),
        )
        for k in (
            "value_support_size",
            "reward_support_size",
            "reward_head_hidden_channels",
            "value_head_hidden_channels",
            "policy_head_hidden_channels",
            "proj_hid",
            "proj_out",
            "pred_hid",
            "pred_out",
        ):
            if k in model_cfg:
                v = model_cfg[k]
                kwargs[k] = tuple(v) if isinstance(v, list) else v
        return MuZeroModel(generator=generator, **kwargs)
