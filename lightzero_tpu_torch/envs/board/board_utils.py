"""Batched board-game primitives (``lightzero_tpu/envs/board/board_utils.py``)
and the two-player board env that TicTacToe and Connect4 share.

Every winning line of a board is precomputed as flat cell indices (numpy,
``make_lines``); a win is then one gather and a reduction over the lines
(``wins``), and a win in one move (``would_win``, the rule bot's test) a
gather, a count and a scatter back to the cells.

``BoardEnv`` holds the battle modes of the JAX envs (tictactoe.py,
connect4.py, gomoku.py, go.py, chess.py): in ``self_play_mode`` each step
places one stone for the player to move, reward +1 to the mover on a win
(and -1 on a loss in Go and Chess, ``self_play_reward``); in ``play_with_bot_mode``
and ``eval_mode`` the agent's stone is answered by the rule bot's, reward
+1 / -1 / 0 from the agent's side when the game ends. A game that ends
resets itself. The bot's one random draw, its tie-breaking uniforms
(``draw_step``), is kept apart from the deterministic transition
(``transition``), so that a caller can hand in draws made elsewhere, as the
tests hand in the JAX env's. Outside self-play, ``to_play`` is -1, the
search's one-player semantics (tictactoe_env.py:235-251 in the reference).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv

BATTLE_MODES = ("self_play_mode", "play_with_bot_mode", "eval_mode")


def make_lines(h: int, w: int, n: int) -> np.ndarray:
    """All length-n straight lines on an h x w board, as flat indices (L, n)."""
    lines = []
    for r in range(h):
        for c in range(w):
            for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
                rr, cc = r + (n - 1) * dr, c + (n - 1) * dc
                if 0 <= rr < h and 0 <= cc < w:
                    lines.append([(r + i * dr) * w + (c + i * dc) for i in range(n)])
    return np.asarray(lines, np.int32)


def wins(board: torch.Tensor, lines: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """(B,) bool: some line of ``board`` (B, cells) is all ``player`` (B,)."""
    vals = board[:, lines]  # (B, L, n)
    return (vals == player.to(board.dtype)[:, None, None]).all(dim=2).any(dim=1)


def would_win(board: torch.Tensor, lines: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """(B, cells) bool: placing ``player`` at that empty cell completes a
    line."""
    vals = board[:, lines]  # (B, L, n)
    own = (vals == player.to(board.dtype)[:, None, None]).sum(dim=2)
    empty = vals == 0
    critical = (own == lines.shape[1] - 1) & (empty.sum(dim=2) == 1)  # (B, L)
    hits = (critical[:, :, None] & empty).reshape(board.shape[0], -1).to(torch.int32)
    cells = torch.zeros(board.shape, dtype=torch.int32, device=board.device)
    cells.scatter_add_(1, lines.reshape(1, -1).expand(board.shape[0], -1).long(), hits)
    return (cells > 0) & (board == 0)


class BoardState(NamedTuple):
    board: torch.Tensor  # (B, cells) int8: 0 empty, 1, 2
    to_play: torch.Tensor  # (B,) int32, 1 or 2
    done: torch.Tensor  # (B,) bool
    winner: torch.Tensor  # (B,) int32: 0 none or draw, 1, 2
    t: torch.Tensor  # (B,) int32 stones placed


def where_state(cond: torch.Tensor, a, b):
    """Per env, state ``a`` where ``cond`` (B,) holds, else ``b`` (states of
    one NamedTuple type, every field batched on dim 0)."""
    B = cond.shape[0]
    return type(a)(*(torch.where(cond.reshape((B,) + (1,) * (x.dim() - 1)), x, y)
                     for x, y in zip(a, b)))


class BoardEnv(TensorEnv):
    """A two-player game on an H x W board; subclasses give the lines, where
    a stone lands (``place``), the legal moves and the rule bot's scores.
    Go and Chess keep states of their own and override ``step_single`` and
    ``bot_action``; the battle modes (``transition``) are shared."""

    num_players = 2
    H: int
    W: int
    lines_np: np.ndarray

    def __init__(self, battle_mode: str = "self_play_mode"):
        if battle_mode not in BATTLE_MODES:
            raise ValueError(f"battle_mode must be one of {BATTLE_MODES}, got {battle_mode!r}")
        self.battle_mode = battle_mode
        self._lines = {}

    def lines(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._lines:
            self._lines[device] = torch.from_numpy(self.lines_np).long().to(device)
        return self._lines[device]

    # ------------------------------------------------------------ primitives
    def observation(self, s: BoardState) -> torch.Tensor:
        """(B, H, W, 3) planes from the mover's side: own stones, the
        opponent's, and 1 everywhere when player 1 is to move."""
        B = s.board.shape[0]
        own = (s.board == s.to_play.to(s.board.dtype)[:, None]).to(torch.float32)
        opp_player = torch.where(s.to_play == 1, 2, 1).to(s.board.dtype)
        opp = (s.board == opp_player[:, None]).to(torch.float32)
        color = (s.to_play == 1).to(torch.float32)[:, None].expand_as(own)
        return torch.stack([own, opp, color], dim=-1).reshape(B, self.H, self.W, 3)

    def init_state(self, num_envs: int, device) -> BoardState:
        z = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        return BoardState(board=torch.zeros((num_envs, self.H * self.W), dtype=torch.int8,
                                            device=device),
                          to_play=torch.ones_like(z), done=torch.zeros_like(z, dtype=torch.bool),
                          winner=z, t=z.clone())

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[BoardState, torch.Tensor]:
        s = self.init_state(num_envs, generator.device)
        return s, self.observation(s)

    def place(self, s: BoardState, action: torch.Tensor) -> torch.Tensor:
        """(B,) flat cell where the mover's stone for ``action`` lands."""
        raise NotImplementedError

    def step_single(self, s: BoardState, action: torch.Tensor) -> BoardState:
        """One stone for the player to move, no reset (the search's
        simulator; a finished game keeps its winner)."""
        cell = self.place(s, action.to(s.board.device).long())
        board = s.board.scatter(1, cell[:, None], s.to_play.to(s.board.dtype)[:, None])
        won = wins(board, self.lines(board.device), s.to_play)
        done = won | (board != 0).all(dim=1) | s.done
        winner = torch.where(s.done, s.winner, torch.where(won, s.to_play, 0)).to(torch.int32)
        return BoardState(board=board, to_play=torch.where(s.to_play == 1, 2, 1).to(torch.int32),
                          done=done, winner=winner, t=s.t + 1)

    def bot_scores(self, s: BoardState, legal: torch.Tensor) -> torch.Tensor:
        """(B, A) the rule bot's scores before its tie-breaking noise."""
        raise NotImplementedError

    def draw_step(self, num_envs: int, generator: torch.Generator) -> torch.Tensor:
        """(B, A) uniforms: the rule bot's tie-breaking draw of one step."""
        return torch.rand((num_envs, self.action_space_size), generator=generator,
                          device=generator.device)

    def bot_action(self, s: BoardState, noise: torch.Tensor) -> torch.Tensor:
        """(B,) the rule bot's move: a win, else a block, else the best of
        the subclass's preferences, ties broken by ``noise`` (B, A) * 0.5."""
        legal = self.legal_mask(s)
        score = self.bot_scores(s, legal) + noise.to(legal.device) * 0.5
        return torch.argmax(torch.where(legal, score, -torch.inf), dim=1)

    def win_block(self, s: BoardState, cells: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """For each action's landing cell (B, A): (the mover wins there,
        the opponent would win there)."""
        lines = self.lines(s.board.device)
        me = s.to_play
        opp = torch.where(me == 1, 2, 1).to(torch.int32)
        win = torch.gather(would_win(s.board, lines, me), 1, cells)
        block = torch.gather(would_win(s.board, lines, opp), 1, cells)
        return win, block

    # ---------------------------------------------------------- collector API
    def transition(self, s: BoardState, action: torch.Tensor, bot_noise: torch.Tensor) -> EnvStep:
        """One step for every env with the bot's draw ``bot_noise`` (B, A)
        (unused in self-play); a finished game resets."""
        if self.battle_mode == "self_play_mode":
            mover = s.to_play
            ns = self.step_single(s, action)
            reward = self.self_play_reward(ns, mover)
        else:
            agent = s.to_play
            ns = self.step_single(s, action)
            after_bot = self.step_single(ns, self.bot_action(ns, bot_noise))
            ns = where_state(ns.done, ns, after_bot)
            reward = torch.where(ns.done & (ns.winner == agent), 1.0,
                                 torch.where(ns.done & (ns.winner != 0), -1.0, 0.0))
        B = action.shape[0]
        out = where_state(ns.done, self.init_state(B, s.board.device), ns)
        return EnvStep(
            state=out,
            obs=self.observation(out),
            reward=reward.to(torch.float32),
            done=ns.done,
            legal_mask=self.legal_mask(out),
            to_play=self.initial_to_play(out),
            truncated=torch.zeros_like(ns.done),
        )

    def self_play_reward(self, ns, mover: torch.Tensor) -> torch.Tensor:
        """(B,) the self-play reward of the mover: +1 where the move ended
        the game with the mover's win, else 0."""
        return (ns.done & (ns.winner == mover)).to(torch.float32)

    def step(self, state: BoardState, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        return self.transition(state, action, self.draw_step(action.shape[0], generator))

    def initial_to_play(self, state: BoardState) -> torch.Tensor:
        if self.battle_mode == "self_play_mode":
            return state.to_play.to(torch.int32)
        return torch.full_like(state.to_play, -1, dtype=torch.int32)
