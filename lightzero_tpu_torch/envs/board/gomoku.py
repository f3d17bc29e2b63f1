"""Gomoku (``lightzero_tpu/envs/board/gomoku.py``) as a batched two-player
tensor env: a stone per move on a ``board_size`` square board, ``n_in_row``
in a line wins, a full board draws (6 x 6 and four in a row by default, the
reference's mini board). The rule bot plays a win, else a block, else a
cell next to a stone (one point for having any of the eight neighbours
taken). Battle modes, observation and the kept-apart bot draw:
``board_utils.BoardEnv``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from lightzero_tpu_torch.envs.board.board_utils import BoardEnv, BoardState, make_lines


class GomokuEnv(BoardEnv):
    def __init__(self, board_size: int = 6, n_in_row: int = 4,
                 battle_mode: str = "self_play_mode"):
        super().__init__(battle_mode)
        self.H = self.W = self.S = board_size
        self.n = n_in_row
        self.observation_shape = (board_size, board_size, 3)
        self.action_space_size = board_size * board_size
        self.lines_np = make_lines(board_size, board_size, n_in_row)

    def legal_mask(self, s: BoardState) -> torch.Tensor:
        return (s.board == 0) & ~s.done[:, None]

    def place(self, s: BoardState, action: torch.Tensor) -> torch.Tensor:
        return action

    def bot_scores(self, s: BoardState, legal: torch.Tensor) -> torch.Tensor:
        B, S = legal.shape[0], self.S
        cells = torch.arange(S * S, device=legal.device).expand(B, S * S)
        win, block = self.win_block(s, cells)
        # the number of taken cells among the eight neighbours (gomoku.py:86-93)
        grid = F.pad((s.board != 0).to(torch.float32).reshape(B, S, S), (1, 1, 1, 1))
        neigh = sum(grid[:, 1 + dr:1 + dr + S, 1 + dc:1 + dc + S]
                    for dr in (-1, 0, 1) for dc in (-1, 0, 1) if (dr, dc) != (0, 0))
        return (win.to(torch.float32) * 100.0 + block.to(torch.float32) * 10.0
                + torch.clamp(neigh.reshape(B, S * S), max=1.0))
