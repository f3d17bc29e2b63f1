"""Batched tensor environment interface (``lightzero_tpu/envs/base.py``).

The JAX env is a pure function over one env, batched by ``vmap``. Here an
env works on a batch of states held as tensors on one device, and draws its
randomness from a ``torch.Generator`` the caller passes (the device of the
generator is the env's device).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch


class EnvStep(NamedTuple):
    state: Any  # batched env state (post-step, auto-reset applied)
    obs: torch.Tensor  # (B, ...) observation after the step (new episode's if done)
    reward: torch.Tensor  # (B,) reward of the transition
    done: torch.Tensor  # (B,) bool episode ended (before auto-reset)
    legal_mask: torch.Tensor  # (B, A) legal actions of the NEW state
    to_play: torch.Tensor  # (B,) player at the NEW state (-1 for 1p)
    # episode ended by a time limit rather than a terminal state; only
    # meaningful where done is True
    truncated: torch.Tensor  # (B,) bool
    # (B,) int64 true chance code of the transition (stochastic envs such as
    # 2048, for Stochastic MuZero's true chance labels); None reads as zeros
    chance: Optional[torch.Tensor] = None


class TensorEnv:
    """Protocol for batched tensor envs."""

    observation_shape: Any
    action_space_size: int
    num_players: int = 1

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[Any, torch.Tensor]:
        """-> (state, obs) for ``num_envs`` fresh episodes."""
        raise NotImplementedError

    def step(self, state: Any, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        """Apply the actions: (B,) ints, or (B, D) floats in a continuous
        action space (Pendulum). MUST auto-reset every env whose episode ended:
        the returned state and obs belong to the fresh episode there, and
        ``done`` flags the boundary (``base.py:46-50``)."""
        raise NotImplementedError

    def legal_mask(self, state: Any) -> torch.Tensor:
        raise NotImplementedError

    def initial_to_play(self, state: Any) -> torch.Tensor:
        """(B,) int32: the player at fresh states, for the search's backup
        (``base.py:53``): -1 for one-player envs and for board games played
        against the bot; the player to move only in self-play."""
        legal = self.legal_mask(state)
        return torch.full((legal.shape[0],), -1, dtype=torch.int32, device=legal.device)
