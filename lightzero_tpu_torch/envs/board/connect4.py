"""Connect4 (``lightzero_tpu/envs/board/connect4.py``) as a batched
two-player tensor env: 6 x 7 board, row 0 at the bottom, an action drops a
stone into a column, four in a row wins. A column is legal while its top
cell is empty. The rule bot plays a win, else a block (a cell counts only
where the column's next stone lands), else prefers the centre by 0.1 a
column. Battle modes, observation and the kept-apart bot draw:
``board_utils.BoardEnv``."""
from __future__ import annotations

import torch

from lightzero_tpu_torch.envs.board.board_utils import BoardEnv, BoardState, make_lines

H, W = 6, 7
LINES = make_lines(H, W, 4)  # (69, 4)


class Connect4Env(BoardEnv):
    H, W = H, W
    observation_shape = (6, 7, 3)
    action_space_size = 7
    lines_np = LINES

    def legal_mask(self, s: BoardState) -> torch.Tensor:
        top = s.board.reshape(-1, H, W)[:, H - 1]
        return (top == 0) & ~s.done[:, None]

    def _drop_cells(self, s: BoardState) -> torch.Tensor:
        """(B, W) the cell each column's next stone lands in (the top cell
        of a full column)."""
        heights = (s.board.reshape(-1, H, W) != 0).sum(dim=1)
        cols = torch.arange(W, device=heights.device)
        return torch.clamp(heights, 0, H - 1) * W + cols

    def place(self, s: BoardState, action: torch.Tensor) -> torch.Tensor:
        return torch.gather(self._drop_cells(s), 1, action[:, None])[:, 0]

    def bot_scores(self, s: BoardState, legal: torch.Tensor) -> torch.Tensor:
        win, block = self.win_block(s, self._drop_cells(s))
        centre = -torch.abs(torch.arange(W, device=legal.device) - 3).to(torch.float32) * 0.1
        return win.to(torch.float32) * 100.0 + block.to(torch.float32) * 10.0 + centre
