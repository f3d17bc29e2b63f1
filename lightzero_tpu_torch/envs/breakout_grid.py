"""Grid Breakout as a batched tensor env (``lightzero_tpu/envs/breakout_grid.py``).

A 10x10 MinAtar-class Breakout: a paddle on the bottom row moves left,
right or stays; one ball travels diagonally, bouncing off the walls, the
bricks and the paddle; 3 rows of bricks pay +1 when hit and respawn once
all are cleared; an episode ends when the ball passes the paddle, or is
truncated at ``max_steps``; the env then resets itself. Observation
(10, 10, 4) float32 per env: [paddle, ball, ball trail, bricks]. Actions:
0 noop, 1 left, 2 right.

The random draw of a reset (``draw_reset``: the ball's column and whether
it starts moving right) is kept apart from the deterministic step
(``transition``), so that a caller can hand in draws made elsewhere, as the
tests hand in the JAX env's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv

S = 10  # grid side
BRICK_ROWS = 3
NUM_ACTIONS = 3


class BreakoutState(NamedTuple):
    paddle: torch.Tensor  # (B,) int64 column
    ball_r: torch.Tensor  # (B,) int64
    ball_c: torch.Tensor  # (B,) int64
    dr: torch.Tensor  # (B,) int64, +-1
    dc: torch.Tensor  # (B,) int64, +-1
    last_r: torch.Tensor  # (B,) the ball's previous cell
    last_c: torch.Tensor
    bricks: torch.Tensor  # (B, BRICK_ROWS, S) bool
    t: torch.Tensor  # (B,) int64 step counter


class ResetDraws(NamedTuple):
    column: torch.Tensor  # (B,) int64 in [0, S): the ball's first column
    right: torch.Tensor  # (B,) bool: the ball starts moving right


def one_hot_grid(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(B,) cells -> (B, S, S) float32 planes with a 1 at each."""
    B = rows.shape[0]
    grid = torch.zeros((B, S, S), dtype=torch.float32, device=rows.device)
    grid[torch.arange(B, device=rows.device), rows, cols] = 1.0
    return grid


def draw_reset(num_envs: int, generator: torch.Generator) -> ResetDraws:
    dev = generator.device
    return ResetDraws(
        column=torch.randint(0, S, (num_envs,), generator=generator, device=dev),
        right=torch.rand((num_envs,), generator=generator, device=dev) < 0.5,
    )


def reset_state(draws: ResetDraws) -> BreakoutState:
    B, dev = draws.column.shape[0], draws.column.device

    def full(v):
        return torch.full((B,), v, dtype=torch.int64, device=dev)

    c = draws.column.long()
    return BreakoutState(
        paddle=full(S // 2), ball_r=full(BRICK_ROWS + 1), ball_c=c, dr=full(1),
        dc=torch.where(draws.right, 1, -1).long(), last_r=full(BRICK_ROWS + 1), last_c=c,
        bricks=torch.ones((B, BRICK_ROWS, S), dtype=torch.bool, device=dev), t=full(0),
    )


def observe(s: BreakoutState) -> torch.Tensor:
    B = s.paddle.shape[0]
    bricks = torch.zeros((B, S, S), dtype=torch.float32, device=s.paddle.device)
    bricks[:, 1:1 + BRICK_ROWS] = s.bricks.to(torch.float32)
    return torch.stack([one_hot_grid(torch.full_like(s.paddle, S - 1), s.paddle),
                        one_hot_grid(s.ball_r, s.ball_c), one_hot_grid(s.last_r, s.last_c),
                        bricks], dim=-1)


def transition(s: BreakoutState, action: torch.Tensor, draws: ResetDraws,
               max_steps: int = 500) -> EnvStep:
    """One step of every env; where the episode ends the state and obs are
    those of the reset that ``draws`` give."""
    action = action.long()
    B, dev = action.shape[0], action.device
    bidx = torch.arange(B, device=dev)
    move = torch.where(action == 1, -1, torch.where(action == 2, 1, 0))
    paddle = torch.clamp(s.paddle + move, 0, S - 1)
    # wall bounces
    dc = torch.where((s.ball_c + s.dc < 0) | (s.ball_c + s.dc >= S), -s.dc, s.dc)
    dr = torch.where(s.ball_r + s.dr < 0, -s.dr, s.dr)
    nr, nc = s.ball_r + dr, s.ball_c + dc
    # entering a brick pays +1, removes it and reflects dr
    in_bricks = (nr >= 1) & (nr < 1 + BRICK_ROWS)
    br = torch.clamp(nr - 1, 0, BRICK_ROWS - 1)
    hit = in_bricks & s.bricks[bidx, br, nc]
    bricks = s.bricks.clone()
    bricks[bidx, br, nc] = s.bricks[bidx, br, nc] & ~hit
    reward = hit.to(torch.float32)
    dr = torch.where(hit, -dr, dr)
    nr = torch.where(hit, s.ball_r + dr, nr)
    # paddle bounce on the bottom row
    at_bottom = nr >= S - 1
    caught = at_bottom & (nc == paddle)
    dr = torch.where(caught, -dr.abs(), dr)
    nr = torch.where(caught, S - 2, nr)
    lost = at_bottom & ~caught
    # the bricks respawn once all are cleared
    cleared = ~bricks.flatten(1).any(dim=1)
    bricks = bricks | cleared[:, None, None]
    t = s.t + 1
    truncated = t >= max_steps
    done = lost | truncated
    ns = BreakoutState(paddle=paddle, ball_r=torch.clamp(nr, 0, S - 1), ball_c=nc, dr=dr, dc=dc,
                       last_r=s.ball_r, last_c=s.ball_c, bricks=bricks, t=t)
    fresh = reset_state(draws)
    out = BreakoutState(*(torch.where(done.reshape((B,) + (1,) * (n.dim() - 1)), r, n)
                          for r, n in zip(fresh, ns)))
    return EnvStep(
        state=out,
        obs=observe(out),
        reward=reward,
        done=done,
        legal_mask=torch.ones((B, NUM_ACTIONS), dtype=torch.bool, device=dev),
        to_play=torch.full((B,), -1, dtype=torch.int32, device=dev),
        truncated=truncated & ~lost,
    )


class BreakoutGridEnv(TensorEnv):
    observation_shape = (S, S, 4)
    action_space_size = NUM_ACTIONS
    num_players = 1

    def __init__(self, max_steps: int = 500):
        self.max_steps = max_steps

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[BreakoutState, torch.Tensor]:
        s = reset_state(draw_reset(num_envs, generator))
        return s, observe(s)

    def legal_mask(self, state: BreakoutState) -> torch.Tensor:
        return torch.ones((state.t.shape[0], NUM_ACTIONS), dtype=torch.bool, device=state.t.device)

    def step(self, state: BreakoutState, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        return transition(state, action, draw_reset(action.shape[0], generator), self.max_steps)
