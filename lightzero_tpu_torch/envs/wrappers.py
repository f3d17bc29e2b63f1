"""Env wrappers (``lightzero_tpu/envs/wrappers.py``) for batched tensor envs.

``PadVectorObs`` zero-pads a vector observation to ``target_dim``, so that
envs with observations of different widths can share one model (the
multitask entries). ``DiscretizeAction`` drives a continuous env (actions
in [-1, 1]^d) with ``bins ** d`` discrete actions: each dimension takes
``linspace(-1, 1, bins)`` levels, and the action indexes their cartesian
product row-major, the last dimension fastest (both endpoints included, as
in the JAX wrapper). The levels are ``torch.linspace``'s, which may differ
from ``jnp.linspace``'s in the last bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv


class PadVectorObs(TensorEnv):
    """Zero-pad a wrapped env's (B, D) observations to (B, ``target_dim``)."""

    def __init__(self, env: TensorEnv, target_dim: int):
        if isinstance(env.observation_shape, (tuple, list)):
            raise ValueError("PadVectorObs wraps envs with vector observations")
        if int(env.observation_shape) > target_dim:
            raise ValueError(f"observations of {env.observation_shape} exceed {target_dim}")
        self.env = env
        self._pad = target_dim - int(env.observation_shape)
        self.observation_shape = target_dim
        self.action_space_size = env.action_space_size
        self.num_players = env.num_players

    def _pad_obs(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(obs, (0, self._pad))

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[Any, torch.Tensor]:
        s, obs = self.env.reset(num_envs, generator)
        return s, self._pad_obs(obs)

    def step(self, state: Any, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        out = self.env.step(state, action, generator)
        return out._replace(obs=self._pad_obs(out.obs))

    def legal_mask(self, state: Any) -> torch.Tensor:
        return self.env.legal_mask(state)

    def initial_to_play(self, state: Any) -> torch.Tensor:
        return self.env.initial_to_play(state)


class DiscretizeAction(TensorEnv):
    """A continuous env (``continuous`` true, ``action_space_size`` its
    action's dimension d) exposed with ``bins ** d`` discrete actions."""

    continuous = False

    def __init__(self, env: TensorEnv, bins: int):
        if not getattr(env, "continuous", False):
            raise ValueError("DiscretizeAction wraps continuous envs")
        if bins < 2:
            raise ValueError(f"bins must be at least 2, got {bins}")
        self.env = env
        self.bins = bins
        self.action_dim = int(env.action_space_size)
        self.action_space_size = bins ** self.action_dim
        self.observation_shape = env.observation_shape
        self.num_players = env.num_players

    def to_continuous(self, action: torch.Tensor) -> torch.Tensor:
        """(B,) discrete actions -> (B, d) levels, the first dimension the
        slowest-varying."""
        idx = action.long()
        digits = []
        for _ in range(self.action_dim):
            digits.append(idx % self.bins)
            idx = idx // self.bins
        levels = torch.linspace(-1.0, 1.0, self.bins, device=action.device)
        return levels[torch.stack(digits[::-1], dim=1)]

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[Any, torch.Tensor]:
        return self.env.reset(num_envs, generator)

    def step(self, state: Any, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        out = self.env.step(state, self.to_continuous(action), generator)
        return out._replace(legal_mask=self._ones(out.legal_mask))

    def _ones(self, inner_legal: torch.Tensor) -> torch.Tensor:
        return torch.ones((inner_legal.shape[0], self.action_space_size), dtype=torch.bool,
                          device=inner_legal.device)

    def legal_mask(self, state: Any) -> torch.Tensor:
        return self._ones(self.env.legal_mask(state))

    def initial_to_play(self, state: Any) -> torch.Tensor:
        return self.env.initial_to_play(state)
