"""Stochastic MuZero model, MLP branch
(``lightzero_tpu/models/stochastic_muzero.py:35-269``): MuZero's
representation and prediction networks, plus

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

Not ported yet, and refused by ``from_config``: the conv branch (ROADMAP
queue 1, slice 16).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from lightzero_tpu_torch.models.common import (
    MLPTorso,
    PredictionNetworkMLP,
    RepresentationNetworkMLP,
)


class StochasticMZOutput(NamedTuple):
    """Raw head outputs; the policy applies the inverse scalar transform."""

    value_logits: torch.Tensor  # (B, value_support)
    reward_logits: torch.Tensor  # (B, reward_support)
    policy_logits: torch.Tensor  # (B, A) after a chance step, (B, C) after a decision step
    latent_state: torch.Tensor  # (B, latent)


class StochasticMuZeroModel(nn.Module):
    def __init__(
        self,
        observation_shape: int = 256,
        action_space_size: int = 4,
        chance_space_size: int = 32,
        latent_state_dim: int = 256,
        value_support_size: int = 601,
        reward_support_size: int = 601,
        common_layer_num: int = 2,
        norm_type: str = "LN",
        last_linear_layer_init_zero: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        L = latent_state_dim
        obs_dim = int(observation_shape)
        self.action_space_size = action_space_size
        self.chance_space_size = chance_space_size
        self.reward_support_size = reward_support_size
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

    def representation(self, obs: torch.Tensor) -> torch.Tensor:
        return self.representation_network(obs)

    def prediction(self, latent: torch.Tensor):
        return self.prediction_network(latent)

    def afterstate_dynamics(self, latent: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        enc = nn.functional.one_hot(action.long(), self.action_space_size).to(latent.dtype)
        return self.afterstate_dynamics_network(torch.cat([latent, enc], dim=-1))

    def afterstate_prediction(self, afterstate: torch.Tensor):
        """-> (value_logits, chance_logits)."""
        return self.afterstate_prediction_network(afterstate)

    def dynamics(self, afterstate: torch.Tensor, chance: torch.Tensor):
        """-> (next_latent, reward_logits)."""
        enc = nn.functional.one_hot(chance.long(), self.chance_space_size).to(afterstate.dtype)
        next_latent = self.dynamics_network(torch.cat([afterstate, enc], dim=-1))
        return next_latent, self.reward_head(next_latent)

    def chance_encode(self, obs_pair: torch.Tensor):
        """(B, 2 obs_dim) consecutive observations -> (logits, the
        straight-through one-hot of their argmax)."""
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
        if model_cfg.get("model_type", default_type) != "mlp":
            raise NotImplementedError(
                "only model_type='mlp' is ported for Stochastic MuZero "
                "(ROADMAP queue 1, slice 16: conv stack)"
            )
        kwargs = dict(
            observation_shape=obs_shape,
            action_space_size=model_cfg.get("action_space_size", 4),
            chance_space_size=model_cfg.get("chance_space_size", 32),
            latent_state_dim=model_cfg.get("latent_state_dim", 256),
            norm_type=model_cfg.get("norm_type", "LN"),
        )
        for k in ("value_support_size", "reward_support_size"):
            if k in model_cfg:
                kwargs[k] = model_cfg[k]
        return StochasticMuZeroModel(generator=generator, **kwargs)
