"""MuZero-RNN-full-obs model, MLP branch (``lightzero_tpu/models/muzero_rnn.py``):
the world model carries a GRU history through real steps and search steps.
The dynamics torso maps (latent, one-hot action) to the next latent, the GRU
takes the next latent into the history, the reward head reads (next latent,
new history) and the prediction torso (latent, history).

The GRU is ``FlaxGRUCell``, built from flax ``GRUCell``'s parameters: input
kernels ``ir``, ``iz``, ``in`` with biases, recurrent kernels ``hr``, ``hz``
without and ``hn`` with one. ``torch.nn.GRUCell`` computes the same gates
but trains a bias on every recurrent third; here those biases do not exist,
so the parameters, and Adam's steps on them, are flax's.

Refused by ``from_config``: a conv model and tuple observation shapes. The
JAX model has no conv branch to port: it is MLP-only, its ``from_config``
ignores ``model_type`` and its ``init_params`` calls ``int()`` on a tuple
shape (``lightzero_tpu/models/muzero_rnn.py:121-137``, ROADMAP queue 3).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from lightzero_tpu_torch.models.common import (
    MLPTorso,
    RepresentationNetworkMLP,
    SSLProjector,
    lecun_normal_,
)


class RNNNetworkOutput(NamedTuple):
    """Raw head outputs; the policy applies the inverse scalar transform."""

    value_logits: torch.Tensor  # (B, value_support)
    reward_logits: torch.Tensor  # (B, reward_support)
    policy_logits: torch.Tensor  # (B, A)
    latent_state: torch.Tensor  # (B, latent)
    history: torch.Tensor  # (B, rnn_hidden)


class FlaxGRUCell(nn.Module):
    """flax ``GRUCell``: r = sigmoid(W_ir x + b_ir + W_hr h), z likewise,
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), h' = (1 - z) n + z h.
    ``weight_ih`` (3H, in) and ``bias_ih`` (3H) stack ir, iz, in;
    ``weight_hh`` (3H, H) stacks hr, hz, hn; ``bias_hn`` (H) is hn's bias.
    Input kernels are lecun-normal, recurrent kernels orthogonal per gate,
    biases zero, as flax initialises them."""

    def __init__(self, in_dim: int, hidden: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, in_dim))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_hn = nn.Parameter(torch.zeros(hidden))
        with torch.no_grad():
            for gate in range(3):
                rows = slice(gate * hidden, (gate + 1) * hidden)
                self.weight_ih[rows] = lecun_normal_(torch.empty(hidden, in_dim), generator)
                self.weight_hh[rows] = nn.init.orthogonal_(
                    torch.empty(hidden, hidden), generator=generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = nn.functional.linear(x, self.weight_ih, self.bias_ih).chunk(3, dim=-1)
        h_r, h_z, h_n = nn.functional.linear(h, self.weight_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.bias_hn))
        return (1.0 - z) * n + z * h


class MuZeroRNNModel(nn.Module):
    def __init__(
        self,
        observation_shape: int = 4,
        action_space_size: int = 2,
        latent_state_dim: int = 128,
        rnn_hidden_size: int = 128,
        value_support_size: int = 601,
        reward_support_size: int = 601,
        common_layer_num: int = 2,
        norm_type: str = "LN",
        last_linear_layer_init_zero: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        L = latent_state_dim
        self.action_space_size = action_space_size
        self.latent_state_dim = L
        self.rnn_hidden_size = rnn_hidden_size
        self.reward_support_size = reward_support_size
        hidden = (L,) * (common_layer_num - 1)
        self.representation_network = RepresentationNetworkMLP(
            int(observation_shape), L, norm_type, generator=generator)
        self.gru = FlaxGRUCell(L, rnn_hidden_size, generator)
        self.dynamics_torso = MLPTorso(L + action_space_size, hidden, L, norm_type=norm_type,
                                       output_norm=True, output_activation=True,
                                       generator=generator)

        def head(in_dim, out):
            return MLPTorso(in_dim, (32,), out, norm_type=norm_type,
                            last_linear_layer_init_zero=last_linear_layer_init_zero,
                            generator=generator)

        self.reward_head = head(L + rnn_hidden_size, reward_support_size)
        self.prediction_torso = MLPTorso(L + rnn_hidden_size, hidden, L, norm_type=norm_type,
                                         output_norm=True, output_activation=True,
                                         generator=generator)
        self.value_head = head(L, value_support_size)
        self.policy_head = head(L, action_space_size)
        # the flax model always has the projector (its __call__ builds it)
        self.projector = SSLProjector(L, generator=generator)

    def representation(self, obs: torch.Tensor) -> torch.Tensor:
        return self.representation_network(obs)

    def init_history(self, batch_size: int, device=None, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((batch_size, self.rnn_hidden_size), dtype=dtype, device=device)

    def prediction(self, latent: torch.Tensor, history: torch.Tensor):
        x = self.prediction_torso(torch.cat([latent, history], dim=-1))
        return self.value_head(x), self.policy_head(x)

    def dynamics(self, latent: torch.Tensor, history: torch.Tensor, action: torch.Tensor):
        """-> (next_latent, new_history, reward_logits)."""
        enc = nn.functional.one_hot(action.long(), self.action_space_size).to(latent.dtype)
        next_latent = self.dynamics_torso(torch.cat([latent, enc], dim=-1))
        new_history = self.gru(next_latent, history)
        return next_latent, new_history, self.reward_head(torch.cat([next_latent, new_history], -1))

    def initial_inference(self, obs: torch.Tensor) -> RNNNetworkOutput:
        """The history starts at zero, the root's reward logits are a zero pad."""
        latent = self.representation(obs)
        B = latent.shape[0]
        history = self.init_history(B, latent.device, latent.dtype)
        value_logits, policy_logits = self.prediction(latent, history)
        return RNNNetworkOutput(
            value_logits=value_logits,
            reward_logits=torch.zeros((B, self.reward_support_size), dtype=value_logits.dtype,
                                      device=latent.device),
            policy_logits=policy_logits,
            latent_state=latent,
            history=history,
        )

    def recurrent_inference(self, latent: torch.Tensor, history: torch.Tensor,
                            action: torch.Tensor) -> RNNNetworkOutput:
        next_latent, new_history, reward_logits = self.dynamics(latent, history, action)
        value_logits, policy_logits = self.prediction(next_latent, new_history)
        return RNNNetworkOutput(
            value_logits=value_logits,
            reward_logits=reward_logits,
            policy_logits=policy_logits,
            latent_state=next_latent,
            history=new_history,
        )

    def project(self, latent: torch.Tensor, with_grad: bool = True) -> torch.Tensor:
        """SSL projection (flax ``MuZeroRNNModel.project``)."""
        return self.projector(latent, with_grad)

    @staticmethod
    def from_config(model_cfg: Any, generator: Optional[torch.Generator] = None
                    ) -> "MuZeroRNNModel":
        """Build from a ``cfg.policy.model`` tree, reading the keys the flax
        ``from_config`` reads."""
        obs_shape = model_cfg.get("observation_shape", 4)
        if model_cfg.get("model_type", "mlp") != "mlp" or isinstance(obs_shape, (tuple, list)):
            raise NotImplementedError(
                "MuZero-RNN-full-obs has an MLP model on flat observations only: the JAX "
                "model has no conv branch (models/muzero_rnn.py:121-137, ROADMAP queue 3)"
            )
        kwargs = dict(
            observation_shape=obs_shape,
            action_space_size=model_cfg.get("action_space_size", 2),
            latent_state_dim=model_cfg.get("latent_state_dim", 128),
            rnn_hidden_size=model_cfg.get("rnn_hidden_size", 128),
            norm_type=model_cfg.get("norm_type", "LN"),
        )
        for k in ("value_support_size", "reward_support_size"):
            if k in model_cfg:
                kwargs[k] = model_cfg[k]
        return MuZeroRNNModel(generator=generator, **kwargs)
