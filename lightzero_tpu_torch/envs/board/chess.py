"""Chess (``lightzero_tpu/envs/board/chess.py``) as a batched two-player
tensor env, the whole rule set (castling, en passant, promotion, the
fifty-move rule, mate and stalemate, insufficient material, a move cap) as
tensor math, so that AlphaZero's search can use the env as its simulator on
the card.

The encoding is the JAX env's, AlphaZero's 4672 actions: square = rank * 8
+ file (a1 = 0, h1 = 7, a8 = 56), white plays up; action = from_square * 73
+ plane, planes 0-55 the queen slides (direction d of N, NE, E, SE, S, SW,
W, NW times distance 1-7: plane d * 7 + distance - 1; these also carry pawn
pushes and captures, a push to the last rank promoting to a queen, king
steps, and castling as the king's two-file step), 56-63 the knight moves,
64-72 the underpromotions (push, capture toward file - 1, toward file + 1,
times knight, bishop, rook). The observation is (8, 8, 20): the white and
the black piece planes (pawn to king), white to move, the four castling
rights, the en-passant file, the halfmove clock / 100 and a plane of ones.

A move is legal when it is pseudo-legal (``pseudo_legal_mask``) and leaves
the mover's king unattacked. The JAX env decides the latter by vmapping
``make_move`` over all 4672 actions; here ``legal_mask_full`` plays every
action of every board at once as one batched (B, 4672, 64) board tensor and
tests each king square (``square_attacked``), with no loop over actions;
its ``max_boards`` cuts a batch into chunks of that many positions (the
CPU tests' perft uses it to keep memory small). ``step_single`` does it again for the opponent (mate and
stalemate), and the rule bot a third time, to see which moves leave the
moved piece attacked.

The rule bot (``bot_action``): captures by the victim's value times 10, 80
for a queen promotion, 1 for a central square, minus five times the mover's
value where the piece would stand attacked, plus its uniform draw (B, 4672),
kept apart (``draw_step``) as in ``board_utils.BoardEnv``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lightzero_tpu_torch.envs.board.board_utils import BoardEnv

# piece codes, signed by colour: + white, - black
P, N, B, R, Q, K = 1, 2, 3, 4, 5, 6
NUM_ACTIONS = 64 * 73

# direction order of the queen planes and the ray tables: (dr, df)
DIRS = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))
ROOK_DIRS = (0, 2, 4, 6)
KNIGHT_OFF = ((2, 1), (1, 2), (-1, 2), (-2, 1), (-2, -1), (-1, -2), (1, -2), (2, -1))
PIECE_VALUE = (0.0, 1.0, 3.0, 3.0, 5.0, 9.0, 0.0)
CENTRE = (27, 28, 35, 36)


def _sq(r, c):
    return r * 8 + c if 0 <= r < 8 and 0 <= c < 8 else -1


def build_tables() -> dict:
    """The static move-geometry tables (numpy), as the JAX env builds them
    (chess.py:56)."""
    FROM = np.zeros(NUM_ACTIONS, np.int64)
    TO = np.full((2, NUM_ACTIONS), -1, np.int64)  # [white, black]: differ on underpromotions
    DIRID = np.full(NUM_ACTIONS, -1, np.int64)
    DIST = np.zeros(NUM_ACTIONS, np.int64)
    IS_KNIGHT = np.zeros(NUM_ACTIONS, bool)
    IS_UP = np.zeros(NUM_ACTIONS, bool)
    UP_PIECE = np.zeros(NUM_ACTIONS, np.int64)
    UP_DF = np.zeros(NUM_ACTIONS, np.int64)
    PATH = np.full((NUM_ACTIONS, 6), -1, np.int64)  # the squares a slide passes over
    for f in range(64):
        fr, fc = f // 8, f % 8
        for plane in range(73):
            a = f * 73 + plane
            FROM[a] = f
            if plane < 56:
                d, dist = plane // 7, plane % 7 + 1
                dr, df = DIRS[d]
                t = _sq(fr + dr * dist, fc + df * dist)
                TO[0, a] = TO[1, a] = t
                DIRID[a] = d
                DIST[a] = dist
                if t >= 0:
                    for j in range(1, dist):
                        PATH[a, j - 1] = _sq(fr + dr * j, fc + df * j)
            elif plane < 64:
                dr, df = KNIGHT_OFF[plane - 56]
                TO[0, a] = TO[1, a] = _sq(fr + dr, fc + df)
                IS_KNIGHT[a] = True
            else:
                u = plane - 64
                df = (0, -1, 1)[u // 3]
                UP_DF[a] = df
                UP_PIECE[a] = (N, B, R)[u % 3]
                IS_UP[a] = True
                TO[0, a] = _sq(fr + 1, fc + df) if fr == 6 else -1
                TO[1, a] = _sq(fr - 1, fc + df) if fr == 1 else -1
    RAY = np.full((64, 8, 7), -1, np.int64)
    KNT = np.full((64, 8), -1, np.int64)
    KNG = np.full((64, 8), -1, np.int64)
    PAWN_ATK = np.full((2, 64, 2), -1, np.int64)  # whence a [white, black] pawn attacks s
    for s in range(64):
        r, c = s // 8, s % 8
        for d, (dr, df) in enumerate(DIRS):
            for j in range(1, 8):
                RAY[s, d, j - 1] = _sq(r + dr * j, c + df * j)
            KNG[s, d] = _sq(r + dr, c + df)
        for j, (dr, df) in enumerate(KNIGHT_OFF):
            KNT[s, j] = _sq(r + dr, c + df)
        PAWN_ATK[0, s] = [_sq(r - 1, c - 1), _sq(r - 1, c + 1)]
        PAWN_ATK[1, s] = [_sq(r + 1, c - 1), _sq(r + 1, c + 1)]
    IS_ROOK_DIR = np.array([d in ROOK_DIRS for d in range(8)])
    return dict(FROM=FROM, TO=TO, DIRID=DIRID, DIST=DIST, IS_KNIGHT=IS_KNIGHT, IS_UP=IS_UP,
                UP_PIECE=UP_PIECE, UP_DF=UP_DF, PATH=PATH, RAY=RAY, KNT=KNT, KNG=KNG,
                PAWN_ATK=PAWN_ATK, IS_ROOK_DIR=IS_ROOK_DIR,
                PIECE_VALUE=np.asarray(PIECE_VALUE, np.float32),
                CENTRE=np.isin(np.arange(64), CENTRE))


TABLES_NP = build_tables()
_TABLES = {}


def tables(device) -> dict:
    """The move tables as tensors on ``device`` (built once per device)."""
    device = torch.device(device)
    if device not in _TABLES:
        _TABLES[device] = {k: torch.from_numpy(v).to(device) for k, v in TABLES_NP.items()}
    return _TABLES[device]


class ChessState(NamedTuple):
    board: torch.Tensor  # (B, 64) int8 signed piece codes
    to_play: torch.Tensor  # (B,) int32: 1 white, 2 black
    castling: torch.Tensor  # (B, 4) bool: white O-O, white O-O-O, black O-O, black O-O-O
    ep_sq: torch.Tensor  # (B,) int32 en-passant target square, -1 none
    halfmove: torch.Tensor  # (B,) int32 plies since the last capture or pawn move
    done: torch.Tensor  # (B,) bool
    winner: torch.Tensor  # (B,) int32: 0 none or draw, 1 white, 2 black
    t: torch.Tensor  # (B,) int32 plies played


# ---------------------------------------------------------------- board math
def _pget(board: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """``board`` (..., 64) at the squares ``sq`` (..., k), the dims before
    the last broadcast; a square of -1 (off the board) reads as empty."""
    shape = torch.broadcast_shapes(board.shape[:-1], sq.shape[:-1])
    idx = torch.clamp(sq, min=0).expand(shape + sq.shape[-1:])
    vals = torch.gather(board.expand(shape + board.shape[-1:]), -1, idx)
    return torch.where(sq >= 0, vals, torch.zeros((), dtype=board.dtype, device=board.device))


def square_attacked(board: torch.Tensor, sq: torch.Tensor, by_white: torch.Tensor
                    ) -> torch.Tensor:
    """(...) bool: is square ``sq`` (...) of ``board`` (..., 64) attacked by
    white (``by_white``) or black (chess.py:140)? A square of -1 reads as 63,
    as the JAX tables' indexing wraps it."""
    T = tables(board.device)
    sq = torch.remainder(sq, 64)
    s = torch.where(by_white, 1, -1).to(board.dtype)[..., None]
    pawn_from = torch.where(by_white[..., None], T["PAWN_ATK"][0][sq], T["PAWN_ATK"][1][sq])
    hit = ((_pget(board, T["KNT"][sq]) == s * N).any(-1)
           | (_pget(board, T["KNG"][sq]) == s * K).any(-1)
           | (_pget(board, pawn_from) == s * P).any(-1))
    ray_sq = T["RAY"][sq].flatten(-2)  # (..., 56): 8 directions x 7 steps
    ray_p = _pget(board, ray_sq).unflatten(-1, (8, 7))
    occ = (ray_p != 0) | (ray_sq.unflatten(-1, (8, 7)) < 0)  # the edge blocks too
    blocked_before = torch.cumsum(occ.to(torch.int32), dim=-1) - occ.to(torch.int32)
    first = occ & (blocked_before == 0)
    fp = torch.where(first, ray_p, 0).to(torch.int32).sum(-1)  # (..., 8) the first piece
    si = s.to(torch.int32)
    rook_dir = T["IS_ROOK_DIR"]
    hit = hit | (rook_dir & ((fp == si * R) | (fp == si * Q))).any(-1)
    return hit | (~rook_dir & ((fp == si * B) | (fp == si * Q))).any(-1)


def king_square(board: torch.Tensor, white: torch.Tensor) -> torch.Tensor:
    """(...) the square of the king of ``white``'s side (0 without one)."""
    code = torch.where(white, K, -K).to(board.dtype)[..., None]
    return torch.argmax((board == code).to(torch.int32), dim=-1)


def make_move(board: torch.Tensor, castling: torch.Tensor, ep_sq: torch.Tensor,
              action: torch.Tensor, white: torch.Tensor):
    """Play ``action`` (...) for ``white``'s side (...) on ``board`` (..., 64)
    with ``castling`` (..., 4) and ``ep_sq`` (...), the dims before the last
    broadcast: (board, castling, ep_sq, was_capture, was_pawn_move), as
    chess.py:165 computes them for any action, legal or not."""
    T = tables(board.device)
    dev = board.device
    side = torch.where(white, 0, 1)
    f = T["FROM"][action]
    t = T["TO"][side, action]
    ts = torch.clamp(t, min=0)
    piece = _pget(board, f[..., None])[..., 0]
    target = _pget(board, ts[..., None])[..., 0]
    is_pawn = piece.abs() == P
    sgn = torch.where(white, 1, -1).to(torch.int32)

    # en passant: a pawn's diagonal step onto the empty en-passant square
    is_ep = is_pawn & (t == ep_sq) & (target == 0) & (torch.remainder(T["DIRID"][action], 2) == 1)
    ep_victim = torch.clamp(torch.where(white, ts - 8, ts + 8), min=0)
    last_rank = torch.where(white, ts // 8 == 7, ts // 8 == 0)
    promo = torch.where(T["IS_UP"][action], T["UP_PIECE"][action],
                        torch.where(is_pawn & last_rank, Q, 0))
    placed = torch.where(promo > 0, promo * sgn, piece.to(torch.int32)).to(board.dtype)
    is_king = piece.abs() == K
    df = torch.remainder(t, 8) - torch.remainder(f, 8)
    is_castle = is_king & (df.abs() == 2)
    rook_from = torch.clamp(torch.where(df > 0, ts + 1, ts - 2), min=0)
    rook_to = torch.clamp(torch.where(df > 0, ts - 1, ts + 1), min=0)

    # each write is a compare against the 64 squares; a square past 63
    # matches none, as the JAX scatter drops it
    sq = torch.arange(64, device=dev)
    zero = torch.zeros((), dtype=board.dtype, device=dev)
    nb = torch.where(sq == f[..., None], zero, board)
    nb = torch.where(sq == ts[..., None], placed[..., None], nb)
    nb = torch.where(is_ep[..., None] & (sq == ep_victim[..., None]), zero, nb)
    nb = torch.where(is_castle[..., None] & (sq == rook_from[..., None]), zero, nb)
    rook_code = (R * sgn).to(board.dtype)[..., None]
    nb = torch.where(is_castle[..., None] & (sq == rook_to[..., None]), rook_code, nb)

    # castling rights: a king move clears its side's pair; a move from or to
    # a rook's home square clears that right
    clear = torch.stack([is_king & white, is_king & white, is_king & ~white, is_king & ~white],
                        dim=-1)
    homes = torch.tensor([7, 0, 63, 56], device=dev)
    clear = clear | (f[..., None] == homes) | (t[..., None] == homes)
    nc = castling & ~clear
    dbl = is_pawn & ((t - f).abs() == 16)
    nep = torch.where(dbl, torch.div(f + t, 2, rounding_mode="floor"), -1).to(torch.int32)
    return nb, nc, nep, (target != 0) | is_ep, is_pawn


def pseudo_legal_mask(board: torch.Tensor, castling: torch.Tensor, ep_sq: torch.Tensor,
                      white: torch.Tensor) -> torch.Tensor:
    """(B, 4672) geometric legality, the mover's king's safety aside
    (chess.py:223), for ``board`` (B, 64)."""
    T = tables(board.device)
    side = torch.where(white, 0, 1)
    sgn = torch.where(white, 1, -1).to(torch.int32)[:, None]
    f, t = T["FROM"], T["TO"][side]  # (A,), (B, A)
    piece = board[:, f].to(torch.int32)
    mine = piece * sgn
    tgt = _pget(board, t).to(torch.int32) * sgn  # > 0 own, < 0 the opponent's
    on = t >= 0
    path_clear = (_pget(board[:, None, :], T["PATH"][None]) == 0).all(-1)
    d, dist = T["DIRID"], T["DIST"]
    rook_dir = torch.remainder(d, 2) == 0
    slide_ok = (((mine == Q) | ((mine == R) & rook_dir) | ((mine == B) & ~rook_dir)
                 | ((mine == K) & (dist == 1)))
                & on & path_clear & (tgt <= 0) & (d >= 0))
    # pawns move on the queen planes: white N, NE, NW; black S, SE, SW
    w = white[:, None]
    fwd = torch.where(w, 0, 4)
    start_rank = torch.where(w, 1, 6)
    pawn_push1 = (mine == P) & (d == fwd) & (dist == 1) & on & (tgt == 0)
    pawn_push2 = ((mine == P) & (d == fwd) & (dist == 2) & on & (tgt == 0) & path_clear
                  & (f // 8 == start_rank))
    diag = torch.where(w, (d == 1) | (d == 7), (d == 3) | (d == 5))
    pawn_cap = (mine == P) & diag & (dist == 1) & on & ((tgt < 0) | (t == ep_sq[:, None]))
    knight_ok = T["IS_KNIGHT"] & (mine == N) & on & (tgt <= 0)
    up_push = T["IS_UP"] & (mine == P) & on & (T["UP_DF"] == 0) & (tgt == 0)
    up_cap = T["IS_UP"] & (mine == P) & on & (T["UP_DF"] != 0) & (tgt < 0)
    ok = slide_ok | pawn_push1 | pawn_push2 | pawn_cap | knight_ok | up_push | up_cap

    # castling replaces the king's bare two-file slide
    ksq = torch.where(w, 4, 60)
    krank = torch.where(white, 0, 7)
    in_check = square_attacked(board, king_square(board, white), ~white)
    rights = torch.where(w, castling[:, :2], castling[:, 2:])
    rook = (R * sgn[:, 0]).to(board.dtype)

    def at(file):
        return _pget(board, (krank * 8 + file)[:, None])[:, 0]

    oo_ok = (rights[:, 0] & (at(7) == rook) & (at(5) == 0) & (at(6) == 0) & ~in_check
             & ~square_attacked(board, krank * 8 + 5, ~white))
    ooo_ok = (rights[:, 1] & (at(0) == rook) & (at(1) == 0) & (at(2) == 0) & (at(3) == 0)
              & ~in_check & ~square_attacked(board, krank * 8 + 3, ~white))
    k_e2 = (f == ksq) & (d == 2) & (dist == 2)  # O-O
    k_w2 = (f == ksq) & (d == 6) & (dist == 2)  # O-O-O
    castle = (k_e2 & oo_ok[:, None]) | (k_w2 & ooo_ok[:, None])
    return torch.where((k_e2 | k_w2) & (mine == K), castle, ok)


def play_all(board: torch.Tensor, castling: torch.Tensor, ep_sq: torch.Tensor,
             white: torch.Tensor) -> torch.Tensor:
    """(B, 4672, 64) the boards after each of the 4672 actions (legal or
    not) of each position, one batched ``make_move``."""
    actions = torch.arange(NUM_ACTIONS, device=board.device)
    return make_move(board[:, None], castling[:, None], ep_sq[:, None], actions,
                     white[:, None])[0]


def _legal_mask(board, castling, ep_sq, white) -> torch.Tensor:
    nb = play_all(board, castling, ep_sq, white)
    w = white[:, None].expand(nb.shape[:2])
    leaves_check = square_attacked(nb, king_square(nb, w), ~w)
    return pseudo_legal_mask(board, castling, ep_sq, white) & ~leaves_check


def legal_mask_full(board: torch.Tensor, castling: torch.Tensor, ep_sq: torch.Tensor,
                    white: torch.Tensor, max_boards: Optional[int] = None) -> torch.Tensor:
    """(B, 4672) exact legality (chess.py:281): pseudo-legal, and the
    mover's king not attacked after the move, found by playing all 4672
    actions of each board at once. ``max_boards`` cuts the batch into chunks
    of that many positions."""
    n = board.shape[0]
    step = max_boards or max(n, 1)
    if n <= step:
        return _legal_mask(board, castling, ep_sq, white)
    return torch.cat([_legal_mask(board[i:i + step], castling[i:i + step], ep_sq[i:i + step],
                                  white[i:i + step]) for i in range(0, n, step)])


def perft(board: torch.Tensor, castling: torch.Tensor, ep_sq: torch.Tensor,
          white: torch.Tensor, depth: int, max_boards: Optional[int] = None) -> int:
    """The number of move sequences of ``depth`` plies from the positions
    (B, ...) (perft, the standard check of a move generator), one batch of
    positions per ply."""
    for _ in range(depth - 1):
        mask = legal_mask_full(board, castling, ep_sq, white, max_boards)
        pos, act = mask.nonzero(as_tuple=True)
        board, castling, ep_sq, _, _ = make_move(board[pos], castling[pos], ep_sq[pos], act,
                                                 white[pos])
        white = ~white[pos]
    return int(legal_mask_full(board, castling, ep_sq, white, max_boards).sum())


# ------------------------------------------------------------------- the env
START = np.zeros(64, np.int8)
START[8:16] = P
START[48:56] = -P
for _c, _p in enumerate((R, N, B, Q, K, B, N, R)):
    START[_c] = _p
    START[56 + _c] = -_p


class ChessEnv(BoardEnv):
    H = W = 8
    observation_shape = (8, 8, 20)
    action_space_size = NUM_ACTIONS

    def __init__(self, battle_mode: str = "self_play_mode", max_moves: int = 512):
        super().__init__(battle_mode)
        self.max_moves = max_moves

    def init_state(self, num_envs: int, device) -> ChessState:
        z = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        return ChessState(
            board=torch.from_numpy(START).to(device).expand(num_envs, 64).clone(),
            to_play=torch.ones_like(z),
            castling=torch.ones((num_envs, 4), dtype=torch.bool, device=device),
            ep_sq=torch.full_like(z, -1), halfmove=z, done=torch.zeros_like(z, dtype=torch.bool),
            winner=z.clone(), t=z.clone())

    def legal_mask(self, s: ChessState) -> torch.Tensor:
        return legal_mask_full(s.board, s.castling, s.ep_sq, s.to_play == 1) & ~s.done[:, None]

    def observation(self, s: ChessState) -> torch.Tensor:
        """(B, 8, 8, 20) (chess.py:337)."""
        Bn = s.board.shape[0]
        b = s.board
        f32 = torch.float32
        planes = [(b == c).to(f32) for c in range(1, 7)] + [(b == -c).to(f32) for c in range(1, 7)]
        planes.append((s.to_play == 1).to(f32)[:, None].expand(Bn, 64))
        planes += [s.castling[:, i].to(f32)[:, None].expand(Bn, 64) for i in range(4)]
        ep_file = torch.where(s.ep_sq >= 0, torch.remainder(s.ep_sq, 8), -1)
        files = torch.arange(64, device=b.device) % 8
        planes.append((files[None, :] == ep_file[:, None]).to(f32))
        # halfmove / 100 as XLA computes it under jit: a product by the
        # float32 reciprocal
        planes.append((s.halfmove.to(f32) * 0.01)[:, None].expand(Bn, 64))
        planes.append(torch.ones((Bn, 64), dtype=f32, device=b.device))
        return torch.stack(planes, dim=-1).reshape(Bn, 8, 8, 20)

    @staticmethod
    def _insufficient(board: torch.Tensor) -> torch.Tensor:
        """No pawn, rook or queen and at most one minor piece on the board."""
        a = board.to(torch.int32).abs()
        heavy = ((a == P) | (a == R) | (a == Q)).sum(-1)
        minors = ((a == N) | (a == B)).sum(-1)
        return (heavy == 0) & (minors <= 1)

    def step_single(self, s: ChessState, action: torch.Tensor) -> ChessState:
        """One move for the side to move, no reset (chess.py:362)."""
        white = s.to_play == 1
        action = action.to(s.board.device).long()
        nb, nc, nep, cap, pawn = make_move(s.board, s.castling, s.ep_sq, action, white)
        halfmove = torch.where(cap | pawn, 0, s.halfmove + 1).to(torch.int32)
        t = s.t + 1
        opp_moves = legal_mask_full(nb, nc, nep, ~white).any(-1)
        opp_in_check = square_attacked(nb, king_square(nb, ~white), white)
        mate = ~opp_moves & opp_in_check
        stalemate = ~opp_moves & ~opp_in_check
        draw = stalemate | (halfmove >= 100) | (t >= self.max_moves) | self._insufficient(nb)
        winner = torch.where(mate, s.to_play, 0).to(torch.int32)
        return ChessState(board=nb, to_play=torch.where(white, 2, 1).to(torch.int32),
                          castling=nc, ep_sq=nep, halfmove=halfmove, done=s.done | mate | draw,
                          winner=torch.where(s.done, s.winner, winner), t=t)

    def bot_action(self, s: ChessState, noise: torch.Tensor) -> torch.Tensor:
        """(B,) the material-greedy rule bot's move (chess.py:384)."""
        T = tables(s.board.device)
        legal = self.legal_mask(s)
        white = s.to_play == 1
        side = torch.where(white, 0, 1)
        sgn = torch.where(white, 1, -1).to(torch.int32)[:, None]
        f, t = T["FROM"], T["TO"][side]
        val = T["PIECE_VALUE"]
        mover = s.board[:, f].to(torch.int32).abs()
        at_t = _pget(s.board, t).to(torch.int32)
        victim = torch.where(at_t * sgn < 0, at_t, 0).abs()
        ep_cap = (mover == P) & (t == s.ep_sq[:, None])
        gain = val[torch.clamp(victim, max=6)] + torch.where(ep_cap, 1.0, 0.0)
        promo_q = (mover == P) & ((t // 8 == 7) | (t // 8 == 0)) & ~T["IS_UP"]
        centre = T["CENTRE"][torch.remainder(t, 64)] & (t >= 0)
        # would the moved piece stand attacked (one ply of safety)?
        hang = square_attacked(play_all(s.board, s.castling, s.ep_sq, white), t,
                               ~white[:, None].expand(t.shape))
        score = (gain * 10.0 + torch.where(promo_q, 80.0, 0.0) + centre.to(torch.float32)
                 - torch.where(hang, val[torch.clamp(mover, max=6)] * 5.0, 0.0)
                 + noise.to(legal.device))
        return torch.argmax(torch.where(legal, score, -torch.inf), dim=1)

    def self_play_reward(self, ns: ChessState, mover: torch.Tensor) -> torch.Tensor:
        """+1 to the mover for a won game, -1 for a lost one (chess.py:416)."""
        return torch.where(ns.done & (ns.winner == mover), 1.0,
                           torch.where(ns.done & (ns.winner != 0), -1.0, 0.0))


def state_from_fen(fens: Union[str, Sequence[str]], device="cpu") -> ChessState:
    """A batch of positions from FEN strings (one string: a batch of one)
    (chess.py:446)."""
    if isinstance(fens, str):
        fens = [fens]
    codes = {"p": P, "n": N, "b": B, "r": R, "q": Q, "k": K}
    rows = []
    for fen in fens:
        parts = fen.split()
        board = np.zeros(64, np.int8)
        for ri, row in enumerate(parts[0].split("/")):
            c = 0
            for ch in row:
                if ch.isdigit():
                    c += int(ch)
                else:
                    board[(7 - ri) * 8 + c] = codes[ch.lower()] * (1 if ch.isupper() else -1)
                    c += 1
        ep = -1
        if len(parts) > 3 and parts[3] != "-":
            ep = (int(parts[3][1]) - 1) * 8 + (ord(parts[3][0]) - ord("a"))
        rows.append((board, 1 if parts[1] == "w" else 2,
                     [ch in parts[2] for ch in "KQkq"], ep,
                     int(parts[4]) if len(parts) > 4 else 0))
    n = len(rows)

    def col(i, dtype):
        return torch.tensor(np.array([r[i] for r in rows]), dtype=dtype, device=device)

    return ChessState(board=col(0, torch.int8), to_play=col(1, torch.int32),
                      castling=col(2, torch.bool), ep_sq=col(3, torch.int32),
                      halfmove=col(4, torch.int32),
                      done=torch.zeros((n,), dtype=torch.bool, device=device),
                      winner=torch.zeros((n,), dtype=torch.int32, device=device),
                      t=torch.zeros((n,), dtype=torch.int32, device=device))
