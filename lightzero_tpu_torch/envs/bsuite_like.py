"""The two bsuite probes (``lightzero_tpu/envs/bsuite_like.py``) as batched
tensor envs.

- ``DeepSeaEnv`` (size N): the agent descends an N x N grid one row per
  step; action 1 ("right") costs 0.01 / N, and only the all-right
  trajectory reaches the +1 treasure at the bottom right. Observation: the
  one-hot (N, N) board of the agent's cell, flattened (all zeros on the row
  past the bottom). Deterministic. (The JAX env also takes a
  ``randomize_actions`` that it never reads; no config sets it.)
- ``CatchEnv`` (rows x cols): a paddle on the bottom row (actions left,
  stay, right) must catch a ball that falls one row per step from a
  uniform column; +1 on a catch, -1 on a miss, when the ball reaches the
  bottom row. Observation: the (rows, cols) board with the ball and the
  paddle (2 where they share the cell), flattened.

Both reset themselves where an episode ends. Catch's one random draw, the
ball's column at reset (``draw_reset``), is kept apart from the
deterministic transition (``transition``), so that a caller can hand in
draws made elsewhere, as the tests hand in the JAX env's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv


def _one_player_step(state, done: torch.Tensor, obs: torch.Tensor,
                     reward: torch.Tensor, legal: torch.Tensor) -> EnvStep:
    B = done.shape[0]
    return EnvStep(
        state=state,
        obs=obs,
        reward=reward.to(torch.float32),
        done=done,
        legal_mask=legal,
        to_play=torch.full((B,), -1, dtype=torch.int32, device=done.device),
        truncated=torch.zeros_like(done),
    )


def _where_state(done: torch.Tensor, a: NamedTuple, b: NamedTuple) -> NamedTuple:
    return type(a)(*(torch.where(done, x, y) for x, y in zip(a, b)))


class DeepSeaState(NamedTuple):
    row: torch.Tensor  # (B,) int32
    col: torch.Tensor  # (B,) int32
    t: torch.Tensor  # (B,) int32


class DeepSeaEnv(TensorEnv):
    num_players = 1
    action_space_size = 2

    def __init__(self, size: int = 10):
        self.size = int(size)
        self.observation_shape = self.size * self.size
        self.move_cost = 0.01 / self.size

    def observe(self, s: DeepSeaState) -> torch.Tensor:
        n = self.size
        cell = torch.clamp(s.row, max=n - 1).long() * n + s.col.long()
        board = torch.nn.functional.one_hot(cell, n * n).to(torch.float32)
        return board * (s.row < n).to(torch.float32)[:, None]

    def initial_state(self, num_envs: int, device) -> DeepSeaState:
        z = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        return DeepSeaState(row=z, col=z.clone(), t=z.clone())

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[DeepSeaState, torch.Tensor]:
        s = self.initial_state(num_envs, generator.device)
        return s, self.observe(s)

    def legal_mask(self, state: DeepSeaState) -> torch.Tensor:
        return torch.ones((state.row.shape[0], 2), dtype=torch.bool, device=state.row.device)

    def step(self, state: DeepSeaState, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        right = action.to(state.col.device) == 1
        col = torch.where(right, torch.clamp(state.col + 1, max=self.size - 1),
                          torch.clamp(state.col - 1, min=0)).to(torch.int32)
        row = state.row + 1
        done = row >= self.size
        treasure = done & (state.col == self.size - 1) & right
        reward = treasure.to(torch.float32) - right.to(torch.float32) * self.move_cost
        ns = DeepSeaState(row=row, col=col, t=state.t + 1)
        out = _where_state(done, self.initial_state(done.shape[0], done.device), ns)
        return _one_player_step(out, done, self.observe(out), reward, self.legal_mask(out))


class CatchState(NamedTuple):
    ball_row: torch.Tensor  # (B,) int32
    ball_col: torch.Tensor  # (B,) int32
    paddle: torch.Tensor  # (B,) int32
    t: torch.Tensor  # (B,) int32


class CatchEnv(TensorEnv):
    num_players = 1
    action_space_size = 3  # left, stay, right

    def __init__(self, rows: int = 10, cols: int = 5):
        self.rows, self.cols = int(rows), int(cols)
        self.observation_shape = self.rows * self.cols

    def observe(self, s: CatchState) -> torch.Tensor:
        R, C = self.rows, self.cols
        ball = torch.clamp(s.ball_row, max=R - 1).long() * C + s.ball_col.long()
        paddle = (R - 1) * C + s.paddle.long()
        return (torch.nn.functional.one_hot(ball, R * C)
                + torch.nn.functional.one_hot(paddle, R * C)).to(torch.float32)

    def draw_reset(self, num_envs: int, generator: torch.Generator) -> torch.Tensor:
        """(B,) int32 ball columns of fresh episodes, uniform."""
        return torch.randint(0, self.cols, (num_envs,), generator=generator,
                             device=generator.device, dtype=torch.int32)

    def initial_state(self, ball_col: torch.Tensor) -> CatchState:
        z = torch.zeros_like(ball_col, dtype=torch.int32)
        return CatchState(ball_row=z, ball_col=ball_col.to(torch.int32),
                          paddle=torch.full_like(z, self.cols // 2), t=z.clone())

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[CatchState, torch.Tensor]:
        s = self.initial_state(self.draw_reset(num_envs, generator))
        return s, self.observe(s)

    def legal_mask(self, state: CatchState) -> torch.Tensor:
        return torch.ones((state.paddle.shape[0], 3), dtype=torch.bool, device=state.paddle.device)

    def transition(self, state: CatchState, action: torch.Tensor, reset_col: torch.Tensor
                   ) -> EnvStep:
        """One step for every env; where the episode ends the next one
        starts with its ball in ``reset_col``."""
        move = action.to(state.paddle.device).to(torch.int32) - 1
        paddle = torch.clamp(state.paddle + move, 0, self.cols - 1).to(torch.int32)
        ball_row = state.ball_row + 1
        done = ball_row >= self.rows - 1
        caught = state.ball_col == paddle
        reward = torch.where(done, torch.where(caught, 1.0, -1.0), 0.0)
        ns = CatchState(ball_row=ball_row, ball_col=state.ball_col, paddle=paddle, t=state.t + 1)
        out = _where_state(done, self.initial_state(reset_col), ns)
        return _one_player_step(out, done, self.observe(out), reward, self.legal_mask(out))

    def step(self, state: CatchState, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        return self.transition(state, action, self.draw_reset(action.shape[0], generator))
