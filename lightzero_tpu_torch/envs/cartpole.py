"""CartPole-v0 as a batched tensor env (``lightzero_tpu/envs/cartpole.py``):
gym's CartPoleEnv physics in float32, episodes of at most 200 steps, and an
automatic reset where an episode ends."""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSCART + MASSPOLE
LENGTH = 0.5  # half pole length
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * math.pi / 360
X_THRESHOLD = 2.4


class CartPoleState(NamedTuple):
    x: torch.Tensor  # (B,) f32
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # (B,) int32 step counter


def observe(s: CartPoleState) -> torch.Tensor:
    return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1).to(torch.float32)


def initial_state(vals: torch.Tensor) -> CartPoleState:
    """A fresh episode from (B, 4) values drawn from U(-0.05, 0.05)."""
    return CartPoleState(
        vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3],
        torch.zeros(vals.shape[0], dtype=torch.int32, device=vals.device),
    )


def transition(
    state: CartPoleState, action: torch.Tensor, reset_state: CartPoleState,
    max_episode_steps: int = 200,
) -> EnvStep:
    """One physics step for every env; where the episode ends the state and
    obs are replaced by ``reset_state``'s."""
    force = torch.where(action == 1, FORCE_MAG, -FORCE_MAG).to(torch.float32)
    costheta = torch.cos(state.theta)
    sintheta = torch.sin(state.theta)
    temp = (force + POLEMASS_LENGTH * state.theta_dot**2 * sintheta) / TOTAL_MASS
    thetaacc = (GRAVITY * sintheta - costheta * temp) / (
        LENGTH * (4.0 / 3.0 - MASSPOLE * costheta**2 / TOTAL_MASS)
    )
    xacc = temp - POLEMASS_LENGTH * thetaacc * costheta / TOTAL_MASS
    x = state.x + TAU * state.x_dot
    x_dot = state.x_dot + TAU * xacc
    theta = state.theta + TAU * state.theta_dot
    theta_dot = state.theta_dot + TAU * thetaacc
    t = state.t + 1
    new_state = CartPoleState(x, x_dot, theta, theta_dot, t)

    failed = (torch.abs(x) > X_THRESHOLD) | (torch.abs(theta) > THETA_THRESHOLD)
    truncated = ~failed & (t >= max_episode_steps)
    done = failed | truncated
    out_state = CartPoleState(
        *(torch.where(done, r, n) for r, n in zip(reset_state, new_state))
    )
    B = action.shape[0]
    dev = action.device
    return EnvStep(
        state=out_state,
        obs=observe(out_state),
        reward=torch.ones(B, dtype=torch.float32, device=dev),
        done=done,
        legal_mask=torch.ones((B, 2), dtype=torch.bool, device=dev),
        to_play=torch.full((B,), -1, dtype=torch.int32, device=dev),
        truncated=truncated,
        chance=torch.zeros(B, dtype=torch.int64, device=dev),
    )


class CartPoleEnv(TensorEnv):
    observation_shape = 4
    action_space_size = 2
    num_players = 1

    def __init__(self, max_episode_steps: int = 200):
        self.max_episode_steps = max_episode_steps

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[CartPoleState, torch.Tensor]:
        vals = torch.rand((num_envs, 4), generator=generator, device=generator.device) * 0.1 - 0.05
        s = initial_state(vals)
        return s, observe(s)

    def legal_mask(self, state: CartPoleState) -> torch.Tensor:
        return torch.ones((state.x.shape[0], 2), dtype=torch.bool, device=state.x.device)

    def step(self, state: CartPoleState, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        reset_state, _ = self.reset(action.shape[0], generator)
        return transition(state, action, reset_state, self.max_episode_steps)
