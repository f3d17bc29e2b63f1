"""Go (``lightzero_tpu/envs/board/go.py``) as a batched two-player tensor env,
the whole rule set as tensor math so that AlphaZero's search can use the env
as its simulator on the card:

- a play removes the opponent's groups left without liberties;
- suicide is illegal: a point is legal iff it is empty, not the ko point,
  and has an empty neighbour, or captures a neighbouring opponent group in
  atari, or joins an own group with two or more liberties;
- simple ko: after a single-stone capture by a lone stone left with one
  liberty, the captured point is barred for the next move;
- action ``S * S`` passes; two passes in a row, or ``max_moves`` moves
  (2 S^2 by default), end the game, scored by area (stones plus empty
  regions that touch one colour only) with ``komi`` added for white.

Groups are labelled as the JAX env labels them: each stone's label is the
least cell index of its group, reached by propagating the minimum over
same-coloured neighbours to a fixed point. The JAX env runs that loop as a
``jax.lax.while_loop`` on the device. Here each round also jumps every
label to its label's label (``lab = lab[lab]``: a cell's label is a cell of
the same group with a label no larger), which reaches the same fixed point
in fewer rounds, and the flag that ends the loop is read back to the host
once every ``ROUNDS_PER_CHECK`` rounds, not after each. Labels are (B, N),
one row per tree or env.

The rule bot (``bot_action``) scores each legal point: 100 for a capture,
50 for saving an own group in atari, 1 on the third and fourth lines, -1000
for filling an own one-point eye, plus its uniform draw (B, S * S); it
passes when no score is above -100. As in ``board_utils.BoardEnv``, the draw
is kept apart (``draw_step``) so that tests can hand in the JAX env's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from lightzero_tpu_torch.envs.board.board_utils import BoardEnv

# propagation rounds between two read-backs of the convergence flag
ROUNDS_PER_CHECK = 4


class GoState(NamedTuple):
    board: torch.Tensor  # (B, N) int8: 0 empty, 1 black, 2 white
    to_play: torch.Tensor  # (B,) int32: 1 black, 2 white
    done: torch.Tensor  # (B,) bool
    winner: torch.Tensor  # (B,) int32: 0 none or draw, 1, 2
    t: torch.Tensor  # (B,) int32 moves played
    passes: torch.Tensor  # (B,) int32 consecutive passes
    ko_point: torch.Tensor  # (B,) int32 barred point, -1 none


def neighbor_idx(S: int) -> np.ndarray:
    """(N, 4) the up, down, left and right neighbours of each cell, -1 off
    the board (go.py:42)."""
    N = S * S
    out = np.full((N, 4), -1, np.int64)
    for r in range(S):
        for c in range(S):
            i = r * S + c
            if r > 0:
                out[i, 0] = i - S
            if r < S - 1:
                out[i, 1] = i + S
            if c > 0:
                out[i, 2] = i - 1
            if c < S - 1:
                out[i, 3] = i + 1
    return out


_PADDED: dict = {}


def _padded(neigh: torch.Tensor) -> torch.Tensor:
    """(N + 1, 4) the neighbour table with off-board entries pointing at a
    sentinel column N, and a sentinel row N of its own (built once per
    table)."""
    N = neigh.shape[0]
    key = (N, neigh.device)  # the table is a function of the board's size
    if key not in _PADDED:
        _PADDED[key] = torch.cat([torch.where(neigh >= 0, neigh, N),
                                  torch.full((1, 4), N, dtype=neigh.dtype, device=neigh.device)])
    return _PADDED[key]


def _gather_neighbors(x: torch.Tensor, neigh: torch.Tensor, off) -> torch.Tensor:
    """(B, N, 4) ``x`` (B, N) at each cell's neighbours, ``off`` off the
    board."""
    B, N = x.shape
    padded = torch.cat([x, torch.full((B, 1), off, dtype=x.dtype, device=x.device)], dim=1)
    return padded[:, _padded(neigh)[:N]]


def _min_label_fixed_point(member: torch.Tensor, joined: torch.Tensor, neigh: torch.Tensor
                           ) -> torch.Tensor:
    """(B, N) int64: for each member cell, the least index of the cells it is
    joined to through chains of ``joined`` (B, N, 4) neighbour links (which
    must be symmetric); N for the other cells. Min propagation with pointer
    jumping, to the fixed point of the JAX loops (go.py:62-83, 178-188).
    The labels carry a sentinel column N (label N) that off-board and
    unjoined links read."""
    B, N = member.shape
    dev = member.device
    table = _padded(neigh)
    lab = torch.where(member, torch.arange(N, device=dev), N)
    lab = torch.cat([lab, torch.full((B, 1), N, dtype=lab.dtype, device=dev)], dim=1)
    joined = torch.cat([joined, torch.zeros((B, 1, 4), dtype=torch.bool, device=dev)], dim=1)
    while True:
        for _ in range(ROUNDS_PER_CHECK):
            nlab = torch.where(joined, lab[:, table], N)
            new = torch.minimum(lab, nlab.amin(dim=2))
            # every label is a cell of the same group whose own label is no
            # larger, so lab[lab] keeps to the group and only moves down
            new = torch.gather(new, 1, new)
            changed = new != lab
            lab = new
        # a round that changed nothing is at the fixed point: each group
        # carries one label, a cell of the group no larger than any other
        if not bool(changed.any()):
            return lab[:, :N]


def group_labels(board: torch.Tensor, neigh: torch.Tensor) -> torch.Tensor:
    """(B, N) group id of each stone: the least cell index of its connected
    same-coloured group; N for empty cells (go.py:62)."""
    nboard = _gather_neighbors(board, neigh, -1)
    joined = (nboard == board[:, :, None]) & (board[:, :, None] > 0)
    return _min_label_fixed_point(board > 0, joined, neigh)


def group_liberties(board: torch.Tensor, labels: torch.Tensor, neigh: torch.Tensor
                    ) -> torch.Tensor:
    """(B, N + 1) the number of distinct liberties of each group, indexed by
    its group id (slot N collects the empty cells' own entries) (go.py:86)."""
    B, N = board.shape
    empty = board == 0
    nlab = _gather_neighbors(labels, neigh, N)
    nlab = torch.where(empty[:, :, None], nlab, N)
    l0, l1, l2, l3 = nlab.unbind(dim=2)
    # an empty point next to a group on several sides counts once
    counts = torch.stack([
        torch.ones_like(l0),
        (l1 != l0).long(),
        ((l2 != l0) & (l2 != l1)).long(),
        ((l3 != l0) & (l3 != l1) & (l3 != l2)).long(),
    ], dim=2)
    libs = torch.zeros((B, N + 1), dtype=torch.long, device=board.device)
    libs.scatter_add_(1, nlab.reshape(B, -1), counts.reshape(B, -1))
    return libs


def remove_dead(board: torch.Tensor, labels: torch.Tensor, libs: torch.Tensor,
                color: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remove every ``color`` (B,) group without liberties: (board, the
    number of stones removed (B,)) (go.py:108)."""
    N = board.shape[1]
    dead = (board == color[:, None]) & (torch.gather(libs, 1, labels) == 0) & (labels < N)
    return torch.where(dead, torch.zeros_like(board), board), dead.sum(dim=1)


class GoEnv(BoardEnv):
    def __init__(self, board_size: int = 9, komi: float = 7.5,
                 battle_mode: str = "self_play_mode", max_moves: int = 0):
        super().__init__(battle_mode)
        self.H = self.W = self.S = board_size
        self.N = board_size * board_size
        self.komi = float(komi)
        self.max_moves = max_moves or 2 * self.N
        self.observation_shape = (board_size, board_size, 3)
        self.action_space_size = self.N + 1  # and pass
        self._neigh_np = neighbor_idx(board_size)
        r, c = np.arange(self.N) // board_size, np.arange(self.N) % board_size
        line = np.minimum(np.minimum(r, board_size - 1 - r), np.minimum(c, board_size - 1 - c))
        self._opening_np = ((line == 2) | (line == 3)).astype(np.float32)
        self._tables = {}
        self._last = None  # (board, its analysis)

    def _table(self, name: str, device) -> torch.Tensor:
        device = torch.device(device)
        if (name, device) not in self._tables:
            src = {"neigh": self._neigh_np, "opening": self._opening_np}[name]
            self._tables[name, device] = torch.from_numpy(src).to(device)
        return self._tables[name, device]

    def _analysis(self, board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(labels, liberties) of ``board``. The last board's are kept: the
        board ``step_single`` returns is analysed there and again by the
        legal mask and the bot of the new state (no board is changed in
        place)."""
        if self._last is not None and self._last[0] is board:
            return self._last[1]
        neigh = self._table("neigh", board.device)
        labels = group_labels(board, neigh)
        out = labels, group_liberties(board, labels, neigh)
        self._last = (board, out)
        return out

    # ------------------------------------------------------------ primitives
    def _point_facts(self, s: GoState):
        """Per point: the neighbours' colours (-1 off the board) and the
        liberties of the neighbouring groups."""
        labels, libs = self._analysis(s.board)
        neigh = self._table("neigh", s.board.device)
        nboard = _gather_neighbors(s.board, neigh, -1)
        nlabs = _gather_neighbors(labels, neigh, self.N)
        nlibs = torch.gather(libs, 1, nlabs.reshape(nlabs.shape[0], -1)).reshape(nlabs.shape)
        return nboard, nlibs

    def legal_mask_board(self, s: GoState, facts=None) -> torch.Tensor:
        """(B, N) the legal points (pass aside) (go.py:138); ``facts`` are
        ``_point_facts(s)`` where the caller has them."""
        me = s.to_play.to(s.board.dtype)[:, None, None]
        opp = torch.where(me == 1, 2, 1).to(s.board.dtype)
        nboard, nlibs = facts if facts is not None else self._point_facts(s)
        adj_empty = (nboard == 0).any(dim=2)
        captures = ((nboard == opp) & (nlibs == 1)).any(dim=2)
        connects_alive = ((nboard == me) & (nlibs >= 2)).any(dim=2)
        ok = (s.board == 0) & (adj_empty | captures | connects_alive)
        ko = torch.arange(self.N, device=s.board.device)[None, :] == s.ko_point[:, None]
        return ok & ~ko & ~s.done[:, None]

    def legal_mask(self, s: GoState) -> torch.Tensor:
        return torch.cat([self.legal_mask_board(s), ~s.done[:, None]], dim=1)

    def observation(self, s: GoState) -> torch.Tensor:
        """(B, S, S, 3): own stones, the opponent's, 1 where black is to move."""
        B, S = s.board.shape[0], self.S
        me = s.to_play.to(s.board.dtype)[:, None]
        opp = torch.where(me == 1, 2, 1).to(s.board.dtype)
        own = (s.board == me).to(torch.float32)
        other = (s.board == opp).to(torch.float32)
        color = (s.to_play == 1).to(torch.float32)[:, None].expand_as(own)
        return torch.stack([own, other, color], dim=-1).reshape(B, S, S, 3)

    def _score(self, board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(black, white + komi), float32 (B,): area scoring (go.py:170)."""
        B, N = board.shape
        neigh = self._table("neigh", board.device)
        nboard = _gather_neighbors(board, neigh, -1)
        empty = board == 0
        lab = _min_label_fixed_point(empty, empty[:, :, None] & (nboard == 0), neigh)
        nboard0 = torch.where(neigh >= 0, nboard, 0)
        touch_b = (nboard0 == 1).any(dim=2) & empty
        touch_w = (nboard0 == 2).any(dim=2) & empty
        tb = torch.zeros((B, N + 1), dtype=torch.long, device=board.device)
        tw = torch.zeros_like(tb)
        tb.scatter_add_(1, lab, touch_b.long())
        tw.scatter_add_(1, lab, touch_w.long())
        tb = torch.gather(tb, 1, lab) > 0
        tw = torch.gather(tw, 1, lab) > 0
        black = (board == 1).sum(dim=1) + (empty & tb & ~tw).sum(dim=1)
        white = (board == 2).sum(dim=1) + (empty & tw & ~tb).sum(dim=1)
        return black.to(torch.float32), white.to(torch.float32) + self.komi

    def init_state(self, num_envs: int, device) -> GoState:
        z = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        return GoState(board=torch.zeros((num_envs, self.N), dtype=torch.int8, device=device),
                       to_play=torch.ones_like(z), done=torch.zeros_like(z, dtype=torch.bool),
                       winner=z, t=z.clone(), passes=z.clone(), ko_point=torch.full_like(z, -1))

    def step_single(self, s: GoState, action: torch.Tensor) -> GoState:
        """One move for the player to move, no reset (go.py:217)."""
        N = self.N
        dev = s.board.device
        action = action.to(dev).long()
        me = s.to_play.to(s.board.dtype)
        opp = torch.where(me == 1, 2, 1).to(s.board.dtype)
        is_pass = action >= N
        cell = torch.clamp(action, max=N - 1)
        at_cell = torch.arange(N, device=dev)[None, :] == cell[:, None]
        board1 = torch.where(at_cell & ~is_pass[:, None], me[:, None], s.board)
        labels, libs = self._analysis(board1)
        board2, n_removed = remove_dead(board1, labels, libs, opp)
        board2 = torch.where(is_pass[:, None], s.board, board2)
        n_removed = torch.where(is_pass, 0, n_removed)
        # simple ko: a single-stone capture by a lone stone left in atari
        labels2, libs2 = self._analysis(board2)
        my_group = torch.gather(labels2, 1, cell[:, None])
        group_size = (labels2 == my_group).sum(dim=1)
        captured = ((board1 != board2) & (board1 == opp[:, None])).to(torch.int32)
        removed_cell = torch.argmax(captured, dim=1)
        ko = (~is_pass & (n_removed == 1) & (group_size == 1)
              & (torch.gather(libs2, 1, my_group)[:, 0] == 1))
        ko_point = torch.where(ko, removed_cell, -1).to(torch.int32)

        passes = torch.where(is_pass, s.passes + 1, 0).to(torch.int32)
        t = s.t + 1
        game_over = (passes >= 2) | (t >= self.max_moves)
        winner = torch.zeros_like(t)
        # the score only decides games that end here: one read-back spares
        # the area count of every other step
        if bool(game_over.any()):
            black, white = self._score(board2)
            winner = torch.where(black > white, 1, torch.where(white > black, 2, 0))
            winner = torch.where(game_over, winner, 0).to(torch.int32)
        return GoState(board=board2, to_play=torch.where(me == 1, 2, 1).to(torch.int32),
                       done=s.done | game_over, winner=torch.where(s.done, s.winner, winner),
                       t=t, passes=passes, ko_point=ko_point)

    def draw_step(self, num_envs: int, generator: torch.Generator) -> torch.Tensor:
        """(B, S * S) uniforms: the rule bot's draw of one step."""
        return torch.rand((num_envs, self.N), generator=generator, device=generator.device)

    def bot_action(self, s: GoState, noise: torch.Tensor) -> torch.Tensor:
        """(B,) the rule bot's move (go.py:263)."""
        dev = s.board.device
        me = s.to_play.to(s.board.dtype)[:, None, None]
        opp = torch.where(me == 1, 2, 1).to(s.board.dtype)
        facts = self._point_facts(s)
        legal = self.legal_mask_board(s, facts)
        nboard, nlibs = facts
        captures = ((nboard == opp) & (nlibs == 1)).any(dim=2)
        saves = ((nboard == me) & (nlibs == 1)).any(dim=2)
        own_eye = ((nboard == me) | (nboard == -1)).all(dim=2) & (s.board == 0)
        score = (captures.to(torch.float32) * 100.0 + saves.to(torch.float32) * 50.0
                 + self._table("opening", dev) * 1.0 + noise.to(dev)
                 - own_eye.to(torch.float32) * 1000.0)
        score = torch.where(legal, score, -torch.inf)
        best = torch.argmax(score, dim=1)
        return torch.where(score.amax(dim=1) > -100.0, best, self.N)

    def self_play_reward(self, ns: GoState, mover: torch.Tensor) -> torch.Tensor:
        """+1 to the mover for a won game, -1 for a lost one (go.py:301)."""
        return torch.where(ns.done & (ns.winner == mover), 1.0,
                           torch.where(ns.done & (ns.winner != 0), -1.0, 0.0))
