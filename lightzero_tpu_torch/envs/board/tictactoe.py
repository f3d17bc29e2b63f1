"""TicTacToe (``lightzero_tpu/envs/board/tictactoe.py``) as a batched
two-player tensor env: a stone per move on the 3 x 3 board, three in a row
wins, a full board draws. The rule bot wins if it can, else blocks, else
plays a random legal cell. Battle modes, observation and the kept-apart bot
draw: ``board_utils.BoardEnv``."""
from __future__ import annotations

import numpy as np
import torch

from lightzero_tpu_torch.envs.board.board_utils import BoardEnv, BoardState

# the 8 winning lines as flat indices into the 3x3 board
LINES = np.array(
    [
        [0, 1, 2], [3, 4, 5], [6, 7, 8],  # rows
        [0, 3, 6], [1, 4, 7], [2, 5, 8],  # cols
        [0, 4, 8], [2, 4, 6],  # diagonals
    ],
    np.int32,
)


class TicTacToeEnv(BoardEnv):
    H, W = 3, 3
    observation_shape = (3, 3, 3)
    action_space_size = 9
    lines_np = LINES

    def legal_mask(self, s: BoardState) -> torch.Tensor:
        return (s.board == 0) & ~s.done[:, None]

    def place(self, s: BoardState, action: torch.Tensor) -> torch.Tensor:
        return action

    def bot_scores(self, s: BoardState, legal: torch.Tensor) -> torch.Tensor:
        cells = torch.arange(9, device=legal.device).expand(legal.shape[0], 9)
        win, block = self.win_block(s, cells)
        win, block = win & legal, block & legal
        return (win.to(torch.float32) * 100.0 + block.to(torch.float32) * 10.0
                + legal.to(torch.float32))
