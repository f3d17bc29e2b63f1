"""Pendulum-v1 as a batched tensor env (``lightzero_tpu/envs/pendulum.py``):
gym's Pendulum dynamics in float32, episodes that end only at
``max_episode_steps`` (so ``truncated`` equals ``done``), and an automatic
reset to θ ~ U(-π, π), θ̇ ~ U(-1, 1) where an episode ends.

Actions are (B, 1) floats in [-1, 1], scaled to the torque range
(``clip(a, -1, 1) * max_torque``), or, with ``discrete_bins``, (B,) ints
that index uniform bins over [-max_torque, max_torque]. ``gravity`` and
``max_torque`` parameterise the dynamics. The legal mask is all ones.

The random draw is kept apart from what is deterministic: ``initial_state``
maps uniforms on [0, 1) to a fresh episode as ``jax.random.uniform`` maps
its own, and ``PendulumEnv.transition`` steps with the reset states it is
given, so that a caller can hand in draws made elsewhere, as the tests hand
in the JAX env's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
DT = 0.05
G = 10.0
M = 1.0
L = 1.0


class PendulumState(NamedTuple):
    theta: torch.Tensor  # (B,) f32, not wrapped
    theta_dot: torch.Tensor  # (B,) f32
    t: torch.Tensor  # (B,) int32 step counter


def angle_normalize(x: torch.Tensor) -> torch.Tensor:
    """x wrapped to [-π, π), a floor modulo as jnp's ``%``."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def initial_state(u: torch.Tensor) -> PendulumState:
    """A fresh episode from (B, 2) uniforms on [0, 1): θ ~ U(-π, π),
    θ̇ ~ U(-1, 1)."""
    return PendulumState(theta=u[:, 0] * (2 * math.pi) - math.pi, theta_dot=u[:, 1] * 2.0 - 1.0,
                         t=torch.zeros((u.shape[0],), dtype=torch.int32, device=u.device))


def observe(s: PendulumState) -> torch.Tensor:
    return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)


class PendulumEnv(TensorEnv):
    observation_shape = 3
    num_players = 1

    def __init__(self, max_episode_steps: int = 200, discrete_bins: int = 0,
                 gravity: float = G, max_torque: float = MAX_TORQUE):
        self.max_episode_steps = max_episode_steps
        self.discrete_bins = discrete_bins  # 0 = continuous
        self.gravity = float(gravity)
        self.max_torque = float(max_torque)
        self.continuous = not discrete_bins
        # the continuous action's dimension, or the number of bins
        self.action_space_size = discrete_bins or 1

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[PendulumState, torch.Tensor]:
        s = initial_state(torch.rand((num_envs, 2), generator=generator, device=generator.device))
        return s, observe(s)

    def legal_mask(self, state: PendulumState) -> torch.Tensor:
        return torch.ones((state.theta.shape[0], self.action_space_size), dtype=torch.bool,
                          device=state.theta.device)

    def torque(self, action: torch.Tensor) -> torch.Tensor:
        """(B,) torques of (B, 1) float or (B,) int actions."""
        if self.discrete_bins:
            return -self.max_torque + 2 * self.max_torque * action.to(torch.float32) / (
                self.discrete_bins - 1)
        a = action.to(torch.float32).reshape(action.shape[0])
        return torch.clamp(a, -1.0, 1.0) * self.max_torque

    def transition(self, state: PendulumState, action: torch.Tensor,
                   reset_state: PendulumState) -> EnvStep:
        """One step for every env; where the episode ends the state and obs
        are ``reset_state``'s."""
        u = self.torque(action)
        th, thdot = state.theta, state.theta_dot
        cost = angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * self.gravity / (2 * L) * torch.sin(th) + 3.0 / (M * L**2) * u) * DT
        newthdot = torch.clamp(newthdot, -MAX_SPEED, MAX_SPEED)
        new_state = PendulumState(th + newthdot * DT, newthdot, state.t + 1)
        done = new_state.t >= self.max_episode_steps
        out = PendulumState(*(torch.where(done, r, n) for r, n in zip(reset_state, new_state)))
        B = th.shape[0]
        return EnvStep(
            state=out,
            obs=observe(out),
            reward=(-cost).to(torch.float32),
            done=done,
            legal_mask=self.legal_mask(out),
            to_play=torch.full((B,), -1, dtype=torch.int32, device=th.device),
            truncated=done,  # Pendulum ends only by its time limit
        )

    def step(self, state: PendulumState, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        reset_state, _ = self.reset(action.shape[0], generator)
        return self.transition(state, action, reset_state)
