"""Port vs JAX: Gomoku and Go (lightzero_tpu_torch/envs/board/{gomoku,go}.py
against lightzero_tpu/envs/board/{gomoku,go}.py).

- Side by side in both battle modes: 8 games at a time of numpy-seeded
  random legal moves (Go passes rarely), with auto-reset. The JAX env draws
  its rule bot's uniforms from its step key (``bot_rng, _ = split(key)``);
  the test makes the same draw and hands it to the port's ``transition``.
  States, observations, rewards, done flags, legal masks and to-play agree
  exactly at every step; games end won and lost (Go self-play: +1 and -1).
- Go's primitives on positions of random games: group labels, liberties,
  ``remove_dead``, the legal mask, area scores and the bot's move equal the
  JAX functions'.
- The cases of tests/test_go_env.py (capture, suicide, a capture that is
  legal without a liberty, simple ko, two passes and the score, a bot game
  that ends, the self-play loss reward) on both envs, and Gomoku's bot win,
  block and adjacency.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.envs.board import go as jax_go
from lightzero_tpu.envs.board.gomoku import GomokuEnv as JaxGomoku
from lightzero_tpu_torch.envs import GoEnv, GomokuEnv
from lightzero_tpu_torch.envs.board import go

pytestmark = pytest.mark.unittest

B = 8
MODES = ["self_play_mode", "play_with_bot_mode"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax(state):
    return type(state)._make(jnp.asarray(x.numpy()) for x in state)


def _assert_states_equal(got, exp):
    for name, x, y in zip(type(got)._fields, got, exp):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)


def _random_moves(legal, rng, pass_weight):
    p = legal.astype(np.float64)
    if pass_weight is not None:
        p[:, -1] *= pass_weight
    return np.array([rng.choice(len(r), p=r / r.sum()) for r in p])


def _side_by_side(jenv, env, steps, seed, pass_weight=None, noise_cells=None):
    jstate = jax.vmap(lambda _: jenv.init_state())(jnp.arange(B))
    state, obs = env.reset(B, torch.Generator())
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jax.vmap(jenv.observation)(jstate)))
    jstep = jax.jit(jax.vmap(jenv.step))
    cells = noise_cells or env.action_space_size
    rng = np.random.default_rng(seed)
    ends, outcomes = 0, set()
    for t in range(steps):
        a = _random_moves(env.legal_mask(state).numpy(), rng, pass_weight)
        keys = jax.random.split(jax.random.PRNGKey(seed * 1000 + t), B)
        exp = jstep(jstate, jnp.asarray(a, jnp.int32), keys)
        noise = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0], (cells,)))(keys)
        got = env.transition(state, _t(a), _t(noise))
        _assert_states_equal(got.state, exp.state)
        for name in ("obs", "reward", "done", "legal_mask", "to_play"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(exp, name)), err_msg=name)
        jstate, state = exp.state, got.state
        ends += int(got.done.sum())
        outcomes |= set(got.reward[got.done].tolist())
    return ends, outcomes


@pytest.mark.parametrize("mode", MODES)
def test_gomoku_matches_jax_under_its_draws(mode):
    ends, outcomes = _side_by_side(JaxGomoku(board_size=6, n_in_row=4, battle_mode=mode),
                                   GomokuEnv(6, 4, battle_mode=mode), 70, seed=len(mode))
    assert ends >= B
    if mode != "self_play_mode":
        assert {1.0, -1.0} <= outcomes


@pytest.mark.parametrize("mode", MODES)
def test_go_matches_jax_under_its_draws(mode):
    kw = dict(board_size=5, komi=0.5, battle_mode=mode, max_moves=40)
    ends, outcomes = _side_by_side(jax_go.GoEnv(**kw), GoEnv(**kw), 100, seed=len(mode),
                                   pass_weight=0.05, noise_cells=25)
    assert ends >= B and {1.0, -1.0} <= outcomes


def _go_positions(env, n, seed, moves=18):
    """``n`` positions of random 5x5 games, with captures along the way."""
    rng = np.random.default_rng(seed)
    state = env.init_state(n, "cpu")
    for _ in range(moves):
        a = _random_moves(env.legal_mask(state).numpy(), rng, 0.02)
        nxt = env.step_single(state, _t(a))
        state = go.GoState(*(torch.where(nxt.done.reshape((n,) + (1,) * (y.dim() - 1)), x, y)
                             for x, y in zip(state, nxt)))
    return state


def test_go_primitives_match_jax_on_random_positions():
    env, jenv = GoEnv(board_size=5, komi=0.5), jax_go.GoEnv(board_size=5, komi=0.5)
    state = _go_positions(env, 32, seed=4)
    js = _jax(state)
    neigh = torch.from_numpy(go.neighbor_idx(5))
    jneigh = jnp.asarray(jax_go._neighbor_idx(5))
    np.testing.assert_array_equal(neigh.numpy(), np.asarray(jneigh))
    labels = go.group_labels(state.board, neigh)
    jlabels = jax.vmap(lambda b: jax_go.group_labels(b, jneigh))(js.board)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    stones = labels < 25
    assert (stones & (labels != torch.arange(25))).any()  # groups of several stones
    libs = go.group_liberties(state.board, labels, neigh)
    jlibs = jax.vmap(lambda b, l: jax_go.group_liberties(b, l, jneigh))(js.board, jlabels)
    np.testing.assert_array_equal(libs.numpy(), np.asarray(jlibs))
    for color in (1, 2):
        got = go.remove_dead(state.board, labels, libs, torch.full((32,), color, dtype=torch.int8))
        exp = jax.vmap(lambda b, l, lb: jax_go.remove_dead(b, l, lb, jnp.int8(color)))(
            js.board, jlabels, jlibs)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(exp[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(exp[1]))
    np.testing.assert_array_equal(env.legal_mask(state).numpy(),
                                  np.asarray(jax.vmap(jenv.legal_mask)(js)))
    black, white = env._score(state.board)
    jb, jw = jax.vmap(jenv._score)(js.board)
    np.testing.assert_array_equal(black.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(white.numpy(), np.asarray(jw))
    keys = jax.random.split(jax.random.PRNGKey(8), 32)
    noise = jax.vmap(lambda k: jax.random.uniform(k, (25,)))(keys)
    np.testing.assert_array_equal(env.bot_action(state, _t(noise)).numpy(),
                                  np.asarray(jax.vmap(jenv.bot_action)(js, keys)))
    np.testing.assert_array_equal(env.observation(state).numpy(),
                                  np.asarray(jax.vmap(jenv.observation)(js)))


def _go_state(board, to_play=1, ko=-1):
    board = np.asarray(board, np.int8).reshape(1, -1)
    return go.GoState(board=_t(board), to_play=torch.tensor([to_play], dtype=torch.int32),
                      done=torch.tensor([False]), winner=torch.tensor([0], dtype=torch.int32),
                      t=torch.tensor([4], dtype=torch.int32),
                      passes=torch.tensor([0], dtype=torch.int32),
                      ko_point=torch.tensor([ko], dtype=torch.int32))


def _both_step(env, jenv, state, action):
    got = env.step_single(state, torch.tensor([action]))
    exp = jax.vmap(jenv.step_single)(_jax(state), jnp.asarray([action], jnp.int32))
    _assert_states_equal(got, exp)
    return got


def _board(stones, size=5):
    b = np.zeros((size, size), np.int8)
    for color, cells in stones.items():
        for r, c in cells:
            b[r, c] = color
    return b


def test_go_capture_suicide_and_ko_as_the_jax_tests_set_them():
    env, jenv = GoEnv(board_size=5), jax_go.GoEnv(board_size=5)
    # capture of a single stone on its last liberty
    b = _board({2: [(1, 1)], 1: [(0, 1), (2, 1), (1, 0)]})
    ns = _both_step(env, jenv, _go_state(b), 1 * 5 + 2)
    assert ns.board[0, 6] == 0 and ns.board[0, 7] == 1
    # suicide is illegal for white, legal for black (it joins live stones)
    b = _board({1: [(0, 1), (2, 1), (1, 0), (1, 2)]})
    for to_play, legal in ((2, False), (1, True)):
        s = _go_state(b, to_play)
        mask = env.legal_mask_board(s)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jax.vmap(jenv.legal_mask_board)(
            _jax(s))))
        assert bool(mask[0, 6]) == legal
    # a capture is legal without a liberty of its own
    b = _board({2: [(1, 1), (0, 2), (2, 2), (1, 3)], 1: [(0, 1), (2, 1), (1, 0)]})
    assert bool(env.legal_mask_board(_go_state(b))[0, 7])
    # simple ko: the recapture is barred for one move
    b = _board({1: [(1, 1), (0, 2), (2, 2)], 2: [(0, 3), (2, 3), (1, 4), (1, 2)]})
    ns = _both_step(env, jenv, _go_state(b), 1 * 5 + 3)
    assert ns.board[0, 7] == 0 and int(ns.ko_point[0]) == 7
    assert not bool(env.legal_mask(ns)[0, 7])
    # the barred point opens again after another move
    ns = _both_step(env, jenv, ns, 24)
    assert int(ns.ko_point[0]) == -1


def test_go_two_passes_score_and_self_play_loss():
    env, jenv = GoEnv(board_size=5, komi=0.5), jax_go.GoEnv(board_size=5, komi=0.5)
    b = np.zeros((5, 5), np.int8)
    b[:, 2] = 1
    b[0, 4] = 2
    ns = _both_step(env, jenv, _go_state(b), 25)  # black passes
    assert not bool(ns.done[0]) and int(ns.passes[0]) == 1
    ns = _both_step(env, jenv, ns, 25)  # white passes: over
    assert bool(ns.done[0]) and int(ns.winner[0]) == 1
    sp = GoEnv(board_size=5, komi=0.5, battle_mode="self_play_mode")
    b = np.zeros((5, 5), np.int8)
    b[:, 2] = 1
    out = sp.transition(_go_state(b), torch.tensor([25]), torch.zeros((1, 25)))
    out = sp.transition(out.state, torch.tensor([25]), torch.zeros((1, 25)))
    # the mover of the last step is white, who loses
    assert bool(out.done[0]) and float(out.reward[0]) == -1.0
    assert int(out.state.board.abs().sum()) == 0  # reset


def test_go_bot_game_ends_and_bot_passes_without_a_sensible_move():
    env = GoEnv(board_size=5, battle_mode="play_with_bot_mode", max_moves=60)
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(1, gen)
    assert obs.shape == (1, 5, 5, 3) and env.action_space_size == 26
    rng = np.random.default_rng(0)
    for _ in range(70):
        out = env.step(state, _t(_random_moves(env.legal_mask(state).numpy(), rng, 1.0)), gen)
        state = out.state
        if bool(out.done[0]):
            break
    assert bool(out.done[0])
    # every empty point is an own eye: the bot passes
    b = np.ones((5, 5), np.int8)
    b[0, 0] = b[2, 2] = b[4, 4] = 0
    assert int(env.bot_action(_go_state(b, 1), torch.zeros((1, 25)))[0]) == 25


def test_gomoku_bot_wins_blocks_and_prefers_neighbours():
    env, jenv = GomokuEnv(6, 4), JaxGomoku(board_size=6, n_in_row=4)
    from lightzero_tpu_torch.envs.board.board_utils import BoardState

    def pos(cells, to_play):
        board = np.zeros(36, np.int8)
        for color, idx in cells.items():
            board[list(idx)] = color
        return BoardState(board=_t(board[None]), to_play=torch.tensor([to_play], dtype=torch.int32),
                          done=torch.tensor([False]), winner=torch.tensor([0], dtype=torch.int32),
                          t=torch.tensor([int((board != 0).sum())], dtype=torch.int32))

    noise = jnp.zeros((36,))
    cases = [({1: (0, 1, 2), 2: (6, 7)}, 1, 3),  # win
             ({1: (0, 1, 2), 2: (12, 13)}, 2, 3),  # block
             ({1: (14,)}, 2, None)]  # next to the stone
    for cells, to_play, expected in cases:
        s = pos(cells, to_play)
        got = int(env.bot_action(s, _t(noise)[None])[0])
        js = type(s)._make(jnp.asarray(x.numpy()[0]) for x in s)
        assert got == int(jenv.bot_action(js, jax.random.PRNGKey(0))) or expected is None
        if expected is not None:
            assert got == expected
        else:
            assert got in (7, 8, 9, 13, 15, 19, 20, 21)
    s = pos({1: (0, 6, 12)}, 1)
    ns = env.step_single(s, torch.tensor([18]))
    assert bool(ns.done[0]) and int(ns.winner[0]) == 1
