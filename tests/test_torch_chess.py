"""Port vs JAX: Chess (lightzero_tpu_torch/envs/board/chess.py against
lightzero_tpu/envs/board/chess.py), on the CPU.

- Perft: the port's ``legal_mask_full`` and ``make_move`` count the
  standard node counts of all twelve cases of tests/test_chess_env.py
  exactly (depths 1-3 from the start position, Kiwipete and positions 3-5),
  positions batched, at most 32 boards per (B, 4672, 64) tensor.
- The static move tables equal the JAX env's.
- Legal masks of the FENs of tests/test_chess_env.py (and positions with en
  passant, castling either way, promotion, stalemate) equal the JAX mask.
- ``step_single`` from those FENs on their special moves (fool's mate, en
  passant, both castlings, promotion and underpromotion, stalemate, the
  fifty-move rule, insufficient material) equals the JAX step, state for
  state.
- Side by side in both battle modes from four of the FENs: numpy-seeded
  random legal moves, the rule bot's uniforms drawn from the JAX step key
  and handed to the port's ``transition``; states, observations, rewards,
  done flags and legal masks agree exactly at every step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.envs.board import chess as jax_chess
from lightzero_tpu_torch.envs import ChessEnv
from lightzero_tpu_torch.envs.board import chess

pytestmark = pytest.mark.unittest

START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
KIWIPETE = "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1"
POS3 = "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1"
POS4 = "r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1"
POS5 = "rnbq1k1r/pp1Pbppp/2p5/8/2B5/8/PPP1NnPP/RNBQK2R w KQ - 1 8"
EN_PASSANT = "rnbqkbnr/1pp1pppp/p7/3pP3/8/8/PPPP1PPP/RNBQKBNR w KQkq d6 0 3"
CASTLE = "r3k2r/pppppppp/8/8/8/8/PPPPPPPP/R3K2R w KQkq - 0 1"
STALEMATED = "k7/2Q5/2K5/8/8/8/8/8 b - - 0 1"
STALEMATE_IN_ONE = "k7/8/2K5/8/8/8/2Q5/8 w - - 0 1"
FIFTY = "k7/8/2K5/8/8/8/2Q5/8 w - - 99 80"
PROMOTE = "8/P6k/8/8/8/8/8/K7 w - - 0 1"
BARE = "k7/8/8/8/8/8/1n6/K7 w - - 0 1"
FENS = [START, KIWIPETE, POS3, POS4, POS5, EN_PASSANT, CASTLE, STALEMATED, STALEMATE_IN_ONE,
        FIFTY, PROMOTE, BARE]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def perft(fen, depth):
    s = chess.state_from_fen(fen)
    return chess.perft(s.board, s.castling, s.ep_sq, s.to_play == 1, depth, max_boards=32)


@pytest.mark.parametrize("fen,depth,expected", [
    (START, 1, 20),
    (START, 2, 400),
    (START, 3, 8902),
    (KIWIPETE, 1, 48),
    (KIWIPETE, 2, 2039),
    (POS3, 1, 14),
    (POS3, 2, 191),
    (POS3, 3, 2812),
    (POS4, 1, 6),
    (POS4, 2, 264),
    (POS5, 1, 44),
    (POS5, 2, 1486),
])
def test_perft(fen, depth, expected):
    assert perft(fen, depth) == expected


def test_move_tables_are_the_jax_envs():
    ref = jax_chess._build_tables()
    for name, table in ref.items():
        np.testing.assert_array_equal(chess.TABLES_NP[name], table, err_msg=name)
    np.testing.assert_array_equal(chess.START, jax_chess._START)


@jax.jit
def _jax_mask(board, castling, ep, white):
    return jax_chess.legal_mask_full(jax_chess._MoveCtx(board, castling, ep, white))


def _jax_state(fen):
    return jax_chess.state_from_fen(fen)


def test_legal_masks_match_jax():
    s = chess.state_from_fen(FENS)
    got = chess.legal_mask_full(s.board, s.castling, s.ep_sq, s.to_play == 1, max_boards=5)
    for i, fen in enumerate(FENS):
        js = _jax_state(fen)
        for name, x, y in zip(chess.ChessState._fields, s, js):
            np.testing.assert_array_equal(x[i].numpy(), np.asarray(y), err_msg=name)
        exp = np.asarray(_jax_mask(js.board, js.castling, js.ep_sq, js.to_play == 1))
        np.testing.assert_array_equal(got[i].numpy(), exp, err_msg=fen)
    assert got[FENS.index(STALEMATED)].sum() == 0
    pseudo = chess.pseudo_legal_mask(s.board, s.castling, s.ep_sq, s.to_play == 1)
    assert (got <= pseudo).all() and (pseudo.sum() > got.sum())


def _act(frm, to, plane=None):
    for a in range(frm * 73, (frm + 1) * 73):
        if (plane is None or a % 73 == plane) and int(chess.TABLES_NP["TO"][0, a]) == to:
            return a
    raise AssertionError("no action")


def _sq(name):
    return (int(name[1]) - 1) * 8 + (ord(name[0]) - ord("a"))


_jax_step = jax.jit(jax.vmap(jax_chess.ChessEnv(max_moves=512).step_single))


def _step_both(fens, actions):
    """One ``step_single`` of each package from each FEN: the port's next
    state, held equal to the JAX env's."""
    env = ChessEnv()
    s = chess.state_from_fen(fens)
    got = env.step_single(s, torch.tensor(actions))
    js = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[_jax_state(f) for f in fens])
    exp = _jax_step(js, jnp.asarray(actions, jnp.int32))
    for name, x, y in zip(chess.ChessState._fields, got, exp):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
    return got


def test_special_moves_step_like_jax():
    cases = [
        (EN_PASSANT, _act(36, 43)),  # exd6 en passant
        (CASTLE, _act(4, 6)),  # O-O
        (CASTLE, _act(4, 2)),  # O-O-O
        (PROMOTE, _act(48, 56)),  # a8=Q
        (PROMOTE, 48 * 73 + 64 + 2),  # a8=R
        (PROMOTE, 48 * 73 + 64),  # a8=N
        (STALEMATE_IN_ONE, _act(10, 50)),  # Qc7, stalemate
        (FIFTY, _act(10, 18)),  # a quiet 100th ply
        (BARE, _act(0, 9)),  # Kxb2: bare kings
        (POS4, _act(_sq("g1"), _sq("h1"))),
    ]
    got = _step_both([f for f, _ in cases], [a for _, a in cases])
    assert int(got.board[0, _sq("d5")]) == 0 and int(got.board[0, _sq("d6")]) == chess.P
    assert int(got.board[1, 6]) == chess.K and int(got.board[1, 5]) == chess.R
    assert not got.castling[1, :2].any() and got.castling[1, 2:].all()
    assert int(got.board[2, 2]) == chess.K and int(got.board[2, 3]) == chess.R
    assert [int(got.board[i, 56]) for i in (3, 4, 5)] == [chess.Q, chess.R, chess.N]
    for i in (6, 7, 8):  # stalemate, fifty moves, insufficient material
        assert bool(got.done[i]) and int(got.winner[i]) == 0
    assert not bool(got.done[9])


def test_fools_mate_steps_like_jax():
    s = chess.state_from_fen(START)
    env, jenv = ChessEnv(), jax_chess.ChessEnv()
    js = _jax_state(START)
    jstep = jax.jit(jenv.step_single)
    for frm, to in (("f2", "f3"), ("e7", "e5"), ("g2", "g4"), ("d8", "h4")):
        a = _act(_sq(frm), _sq(to))
        assert bool(env.legal_mask(s)[0, a])
        s = env.step_single(s, torch.tensor([a]))
        js = jstep(js, jnp.int32(a))
        for name, x, y in zip(chess.ChessState._fields, s, js):
            np.testing.assert_array_equal(x[0].numpy(), np.asarray(y), err_msg=name)
    assert bool(s.done[0]) and int(s.winner[0]) == 2


@pytest.mark.parametrize("mode", ["self_play_mode", "play_with_bot_mode"])
def test_env_matches_jax_under_its_draws(mode):
    env = ChessEnv(battle_mode=mode, max_moves=24)
    jenv = jax_chess.ChessEnv(battle_mode=mode, max_moves=24)
    fens = [START, KIWIPETE, EN_PASSANT, POS5]
    state = chess.state_from_fen(fens)
    jstate = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[_jax_state(f) for f in fens])
    np.testing.assert_array_equal(env.observation(state).numpy(),
                                  np.asarray(jax.vmap(jenv.observation)(jstate)))
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(len(mode))
    ends = 0
    for t in range(30):
        legal = env.legal_mask(state).numpy()
        a = np.array([rng.choice(np.flatnonzero(r)) for r in legal])
        keys = jax.random.split(jax.random.PRNGKey(t), len(fens))
        exp = jstep(jstate, jnp.asarray(a, jnp.int32), keys)
        noise = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0],
                                                      (chess.NUM_ACTIONS,)))(keys)
        got = env.transition(state, torch.from_numpy(a), torch.tensor(np.array(noise)))
        for name, x, y in zip(chess.ChessState._fields, got.state, exp.state):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f"{t} {name}")
        for name in ("obs", "reward", "done", "legal_mask", "to_play"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(exp, name)), err_msg=name)
        jstate, state = exp.state, got.state
        ends += int(got.done.sum())
    assert ends >= len(fens)


def test_bot_takes_the_queen_and_promotes():
    env = ChessEnv()
    s = chess.state_from_fen(["k7/8/8/3q4/8/8/8/K2R4 w - - 0 1", PROMOTE])
    a = env.bot_action(s, torch.zeros((2, chess.NUM_ACTIONS)))
    assert int(a[0]) == _act(_sq("d1"), _sq("d5"))
    assert int(a[1]) == _act(48, 56)
