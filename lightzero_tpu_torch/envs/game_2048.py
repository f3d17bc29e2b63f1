"""2048 as a batched tensor env (``lightzero_tpu/envs/game_2048.py``).

Slide and merge with the reward as the sum of the merged tiles' values; a
move is legal when it changes the board; after a move that changed the
board a tile spawns, a 2 with probability 0.9 or a 4 with 0.1, at a uniform
empty cell, with the chance code ``cell * 2 + is_four`` (32 codes, Stochastic
MuZero's true chance labels). A move that changes nothing spawns nothing and
has chance code 0. An episode ends when no move is legal, or is truncated
after ``max_episode_steps``; the env then resets itself (two spawns on an
empty board). The board holds exponents (0 = empty, k = a tile of 2^k); the
observation is their one-hot planes, (4, 4, 16) per env.

The random draw (``draw_spawn``: the cell and whether the tile is a 4) is
kept apart from the deterministic move and placement (``transition``,
``spawn``), so that a caller can hand in draws made elsewhere, as the tests
hand in the JAX env's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv

NUM_EXPONENTS = 16  # tiles up to 2^15 = 32768
P_FOUR = 0.1


class G2048State(NamedTuple):
    board: torch.Tensor  # (B, 4, 4) int32 exponents, 0 = empty
    score: torch.Tensor  # (B,) f32 cumulative reward
    t: torch.Tensor  # (B,) int32 step counter


def _slide_rows_left(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact and merge rows of 4 exponents to the left (M, 4) ->
    (new rows, reward (M,)): a tile merges with the last unmerged tile
    written, into one of the next exponent, worth 2^(exponent + 1)."""
    # stable-compact the nonzeros to the left
    order = torch.sort((rows == 0).to(torch.int8), dim=1, stable=True).indices
    r = torch.gather(rows, 1, order)
    M = rows.shape[0]
    cols = torch.arange(4, device=rows.device)[None, :]
    out = torch.zeros_like(rows)
    pos = torch.zeros((M,), dtype=rows.dtype, device=rows.device)
    last = torch.zeros_like(pos)
    reward = torch.zeros((M,), dtype=torch.float32, device=rows.device)
    for j in range(4):
        v = r[:, j]
        merge = (v != 0) & (last == v)
        out = torch.where(merge[:, None] & (cols == (pos - 1)[:, None]), (v + 1)[:, None], out)
        reward = reward + torch.where(merge, torch.exp2(v.to(torch.float32) + 1.0), 0.0)
        write_new = (v != 0) & ~merge
        out = torch.where(write_new[:, None] & (cols == pos[:, None]), v[:, None], out)
        pos = pos + write_new.to(pos.dtype)
        last = torch.where(merge, 0, torch.where(v != 0, v, last))
    return out, reward


def slide_all(board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every move of every board: (B, 4, 4) -> (boards (B, 4 moves, 4, 4),
    rewards (B, 4 moves)). Moves: 0 up, 1 right, 2 down, 3 left (gym-2048's
    convention); each is a slide to the left of a view of the board."""
    B = board.shape[0]
    tr = board.transpose(1, 2)
    views = torch.stack([tr, board.flip(2), tr.flip(2), board], dim=1)
    rows, rewards = _slide_rows_left(views.reshape(-1, 4))
    slid = rows.reshape(B, 4, 4, 4)
    rewards = rewards.reshape(B, 4, 4)
    reward = rewards[..., 0] + rewards[..., 1] + rewards[..., 2] + rewards[..., 3]
    back = torch.stack([slid[:, 0].transpose(1, 2), slid[:, 1].flip(2),
                        slid[:, 2].flip(2).transpose(1, 2), slid[:, 3]], dim=1)
    return back, reward


def slide_board(board: torch.Tensor, direction: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 4, 4) boards, (B,) moves -> (the boards after the move, the
    rewards (B,))."""
    boards, rewards = slide_all(board)
    bidx = torch.arange(board.shape[0], device=board.device)
    d = direction.long()
    return boards[bidx, d], rewards[bidx, d]


def legal_moves(board: torch.Tensor) -> torch.Tensor:
    """(B, 4) bool: the moves that change the board."""
    boards, _ = slide_all(board)
    return (boards != board[:, None]).flatten(2).any(dim=2)


def spawn(board: torch.Tensor, cell: torch.Tensor, is_four: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Place a 2 (or a 4 where ``is_four``) at ``cell`` (B,) in 0..15 where
    that cell is empty: (board, chance code cell * 2 + is_four)."""
    B = board.shape[0]
    flat = board.reshape(B, 16)
    c = cell.long()[:, None]
    cur = torch.gather(flat, 1, c)
    val = torch.where(is_four, 2, 1).to(board.dtype)[:, None]
    flat = flat.scatter(1, c, torch.where(cur == 0, val, cur))
    return flat.reshape(B, 4, 4), cell.long() * 2 + is_four.long()


def draw_spawn(board: torch.Tensor, generator: torch.Generator
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cell, is_four): a uniform empty cell (the largest of iid uniforms
    over the empty cells) and a 4 with probability 0.1."""
    B = board.shape[0]
    u = torch.rand((B, 16), generator=generator, device=board.device)
    cell = torch.argmax(torch.where(board.reshape(B, 16) == 0, u, -1.0), dim=1)
    is_four = torch.rand((B,), generator=generator, device=board.device) < P_FOUR
    return cell, is_four


def observe(state: G2048State) -> torch.Tensor:
    return torch.nn.functional.one_hot(state.board.long(), NUM_EXPONENTS).to(torch.float32)


def transition(state: G2048State, action: torch.Tensor, cell: torch.Tensor,
               is_four: torch.Tensor, reset_state: G2048State,
               max_episode_steps: int = 2000) -> EnvStep:
    """One move for every env with the spawn draws (``cell``, ``is_four``);
    where the episode ends the state and obs are ``reset_state``'s."""
    slid, reward = slide_board(state.board, action)
    moved = (slid != state.board).flatten(1).any(dim=1)
    spawned, chance = spawn(slid, cell, is_four)
    board = torch.where(moved[:, None, None], spawned, state.board)
    reward = torch.where(moved, reward, 0.0)
    chance = torch.where(moved, chance, 0)
    t = state.t + 1
    legal = legal_moves(torch.cat([board, reset_state.board]))
    B = board.shape[0]
    no_moves = ~legal[:B].any(dim=1)
    truncated = ~no_moves & (t >= max_episode_steps)
    done = no_moves | truncated
    new_state = G2048State(board=board, score=state.score + reward, t=t)
    out = G2048State(*(torch.where(done.reshape((B,) + (1,) * (r.dim() - 1)), r, n)
                       for r, n in zip(reset_state, new_state)))
    return EnvStep(
        state=out,
        obs=observe(out),
        reward=reward.to(torch.float32),
        done=done,
        legal_mask=torch.where(done[:, None], legal[B:], legal[:B]),
        to_play=torch.full((B,), -1, dtype=torch.int32, device=board.device),
        truncated=truncated,
        chance=chance,
    )


class Game2048Env(TensorEnv):
    observation_shape = (4, 4, NUM_EXPONENTS)
    action_space_size = 4
    chance_space_size = 32
    num_players = 1

    def __init__(self, max_episode_steps: int = 2000):
        self.max_episode_steps = max_episode_steps

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[G2048State, torch.Tensor]:
        dev = generator.device
        board = torch.zeros((num_envs, 4, 4), dtype=torch.int32, device=dev)
        for _ in range(2):
            board, _ = spawn(board, *draw_spawn(board, generator))
        s = G2048State(board=board, score=torch.zeros((num_envs,), dtype=torch.float32, device=dev),
                       t=torch.zeros((num_envs,), dtype=torch.int32, device=dev))
        return s, observe(s)

    def legal_mask(self, state: G2048State) -> torch.Tensor:
        return legal_moves(state.board)

    def step(self, state: G2048State, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        slid, _ = slide_board(state.board, action)
        cell, is_four = draw_spawn(slid, generator)
        reset_state, _ = self.reset(action.shape[0], generator)
        return transition(state, action, cell, is_four, reset_state, self.max_episode_steps)
