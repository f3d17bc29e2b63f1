"""RND (Random Network Distillation) intrinsic reward model
(``lightzero_tpu/reward_model/rnd.py``): a fixed random target net and a
trained predictor, each an ``MLPTorso`` of (256, 256) hidden layers with an
output of 128 over the flattened observation. The intrinsic reward of an
observation is its prediction error, mean over the 128 outputs of
(predictor - target)^2, normalised by running statistics, and is added to
the rewards with a weight that decays linearly to 0 over
``weight_decay_steps`` train steps.

The running statistics are a Welford update over batches, starting at
count 1e-4, mean 0 and M2 1: a batch of n errors with mean m and population
variance v moves count to count + n, the mean by (m - mean) n / (count + n)
and M2 by v n + (m - mean)^2 count n / (count + n); the intrinsic reward is
(error - mean) / sqrt(max(M2 / count, 1e-8)), with the updated statistics.
The predictor trains by Adam at ``learning_rate`` (optax's defaults: b1 0.9,
b2 0.999, eps 1e-8) on the mean squared error.

The JAX model carries its parameters and statistics in an ``RNDState``
pytree that its jitted functions take and return. Here the module holds
the two nets, and ``RNDState`` the predictor's optimizer, the statistics as
0-d float32 tensors on the model's device, and ``train_iter``;
``train_step`` and ``estimate`` take a state and return the next one
(``train_step`` updates the predictor in place, as the policies' learn
steps do). ``train_step`` is the JAX model's ``train``, whose name an
``nn.Module`` keeps for its mode switch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from lightzero_tpu_torch.models.common import MLPTorso
from lightzero_tpu_torch.utils.device import resolve_device


class RNDNet(nn.Module):
    """obs (B, ...) -> (B, out), through an MLP over the flattened obs
    (flax ``_RNDNet``)."""

    def __init__(self, obs_dim: int, hidden: int = 256, out: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.torso = MLPTorso(obs_dim, (hidden, hidden), out, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.torso(x.reshape(x.shape[0], -1))


class RNDState(NamedTuple):
    optimizer: torch.optim.Adam  # the predictor's
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    train_iter: int


class RNDRewardModel(nn.Module):
    def __init__(
        self,
        obs_dim: int,
        learning_rate: float = 3e-4,
        intrinsic_reward_weight: float = 0.01,
        weight_decay_steps: int = 100_000,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        """The target's and the predictor's weights are drawn from ``seed``.
        The model runs on ``device``: ``cuda`` unless the caller names
        another."""
        super().__init__()
        self.device = resolve_device(device)
        self.obs_dim = obs_dim
        self.learning_rate = learning_rate
        self.weight = intrinsic_reward_weight
        self.weight_decay_steps = weight_decay_steps
        g = torch.Generator().manual_seed(seed)
        self.target = RNDNet(obs_dim, generator=g).requires_grad_(False)
        self.predictor = RNDNet(obs_dim, generator=g)
        self.to(self.device)

    def init_state(self) -> RNDState:
        def scalar(x):
            return torch.tensor(x, dtype=torch.float32, device=self.device)

        return RNDState(
            optimizer=torch.optim.Adam(self.predictor.parameters(), lr=self.learning_rate,
                                       eps=1e-8),
            count=scalar(1e-4), mean=scalar(0.0), m2=scalar(1.0), train_iter=0,
        )

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=self.device)

    def error(self, obs) -> torch.Tensor:
        """(B,) prediction errors, mean over the outputs of
        (predictor - target)^2."""
        obs = self._as_tensor(obs)
        with torch.no_grad():
            t = self.target(obs)
        return torch.mean((self.predictor(obs) - t) ** 2, dim=-1)

    def train_step(self, state: RNDState, obs) -> Tuple[RNDState, float]:
        """One Adam step of the predictor on the mean squared error over
        ``obs``: (state, loss)."""
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.mean(self.error(obs))
        loss.backward()
        state.optimizer.step()
        return state._replace(train_iter=state.train_iter + 1), float(loss.detach())

    @torch.no_grad()
    def estimate(self, state: RNDState, obs, rewards):
        """The rewards plus the weighted intrinsic reward of ``obs``, after
        the running statistics take this batch: (state, new rewards (B,),
        intrinsic rewards (B,)), tensors on the model's device."""
        err = self.error(obs)
        rewards = self._as_tensor(rewards)
        n = err.shape[0]
        b_mean = torch.mean(err)
        b_var = torch.var(err, correction=0)
        delta = b_mean - state.mean
        tot = state.count + n
        new_mean = state.mean + delta * n / tot
        new_m2 = state.m2 + b_var * n + delta ** 2 * state.count * n / tot
        std = torch.sqrt(torch.clamp(new_m2 / tot, min=1e-8))
        intrinsic = (err - new_mean) / std
        # the weight times the decay, in float32 as the JAX model takes it
        decay = np.clip(np.float32(1.0) - np.float32(state.train_iter)
                        / np.float32(self.weight_decay_steps), 0.0, 1.0)
        new_rewards = rewards + float(np.float32(self.weight) * np.float32(decay)) * intrinsic
        return state._replace(count=tot, mean=new_mean, m2=new_m2), new_rewards, intrinsic
