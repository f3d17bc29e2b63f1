"""Port vs JAX: TicTacToe and Connect4 (lightzero_tpu_torch/envs/board/
against lightzero_tpu/envs/board/).

- Side by side in both battle modes: 8 games at a time for 60 steps of
  numpy-seeded random legal moves, with auto-reset. The JAX env draws its
  rule bot's tie-breaking uniforms from its step key (``bot_rng, _ =
  split(key)``); the test makes the same draw and hands it to the port's
  ``transition``. States (board, player, done, winner, move count),
  observation planes, rewards, done flags, legal masks and to-play agree
  exactly at every step.
- ``step_single``, ``bot_action``, ``would_win`` and ``observation`` on
  positions of many random games, and the cases of tests/test_tictactoe_env.py
  and tests/test_board_games.py (wins on rows, columns and diagonals, a
  draw, the bot's win and block, gravity, a full column), each held
  against the JAX env's answer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.envs.board.board_utils import make_lines as jax_make_lines
from lightzero_tpu.envs.board.board_utils import would_win as jax_would_win
from lightzero_tpu.envs.board.connect4 import Connect4Env as JaxConnect4
from lightzero_tpu.envs.board.tictactoe import TicTacToeEnv as JaxTicTacToe
from lightzero_tpu_torch.envs import Connect4Env, TicTacToeEnv
from lightzero_tpu_torch.envs.board.board_utils import BoardState, make_lines, would_win

pytestmark = pytest.mark.unittest

B, STEPS = 8, 60
GAMES = [(JaxTicTacToe, TicTacToeEnv), (JaxConnect4, Connect4Env)]
MODES = ["self_play_mode", "play_with_bot_mode"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once: their thread pools would
    fight over the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _jax_state(state: BoardState):
    return type(state)(*(jnp.asarray(x.numpy()) for x in state))


def _bot_noise(jenv, key):
    bot_rng, _ = jax.random.split(key)
    return jax.random.uniform(bot_rng, (jenv.action_space_size,))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("games", GAMES, ids=["tictactoe", "connect4"])
def test_env_matches_jax_under_its_draws(games, mode):
    jax_cls, cls = games
    jenv, env = jax_cls(battle_mode=mode), cls(battle_mode=mode)
    jstate = jax.vmap(lambda _: jenv.init_state())(jnp.arange(B))
    state, obs = env.reset(B, torch.Generator())
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jax.vmap(jenv.observation)(jstate)))
    np.testing.assert_array_equal(env.initial_to_play(state).numpy(),
                                  np.asarray(jax.vmap(jenv.initial_to_play)(jstate)))
    jstep_fn = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(len(mode) + env.action_space_size)
    ends, outcomes = 0, set()
    for t in range(STEPS):
        legal = env.legal_mask(state).numpy()
        a = np.array([rng.choice(np.flatnonzero(row)) for row in legal])
        keys = jax.random.split(jax.random.PRNGKey(t), B)
        jstep = jstep_fn(jstate, jnp.asarray(a, jnp.int32), keys)
        step = env.transition(state, _t(a), _t(jax.vmap(lambda k: _bot_noise(jenv, k))(keys)))
        for name, x, y in zip(BoardState._fields, step.state, jstep.state):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
        np.testing.assert_array_equal(step.obs.numpy(), np.asarray(jstep.obs))
        np.testing.assert_array_equal(step.reward.numpy(), np.asarray(jstep.reward))
        np.testing.assert_array_equal(step.done.numpy(), np.asarray(jstep.done))
        np.testing.assert_array_equal(step.legal_mask.numpy(), np.asarray(jstep.legal_mask))
        np.testing.assert_array_equal(step.to_play.numpy(), np.asarray(jstep.to_play))
        jstate, state = jstep.state, step.state
        ends += int(step.done.sum())
        outcomes |= set(step.reward[step.done].tolist())
    assert ends >= B
    if mode != "self_play_mode":  # self-play rewards the mover's win only
        assert len(outcomes) >= 2  # games won and lost (or drawn) both happened


def _random_positions(env, n, seed):
    """``n`` positions of random games, each some random moves in."""
    rng = np.random.default_rng(seed)
    state = env.init_state(n, "cpu")
    depth = rng.integers(0, env.H * env.W, n)
    for m in range(env.H * env.W):
        legal = env.legal_mask(state).numpy()
        move = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0 for r in legal])
        nxt = env.step_single(state, _t(move))
        keep = _t((m < depth) & legal.any(1))
        state = BoardState(*(torch.where(keep.reshape((n,) + (1,) * (x.dim() - 1)), y, x)
                             for x, y in zip(state, nxt)))
    return state


@pytest.mark.parametrize("games", GAMES, ids=["tictactoe", "connect4"])
def test_primitives_match_jax_on_random_positions(games):
    jax_cls, cls = games
    jenv, env = jax_cls(), cls()
    state = _random_positions(env, 64, seed=env.action_space_size)
    js = _jax_state(state)
    np.testing.assert_array_equal(env.observation(state).numpy(),
                                  np.asarray(jax.vmap(jenv.observation)(js)))
    np.testing.assert_array_equal(env.legal_mask(state).numpy(),
                                  np.asarray(jax.vmap(jenv.legal_mask)(js)))
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    noise = jax.vmap(lambda k: jax.random.uniform(k, (jenv.action_space_size,)))(keys)
    bot = env.bot_action(state, _t(noise))
    np.testing.assert_array_equal(bot.numpy(), np.asarray(jax.vmap(jenv.bot_action)(js, keys)))
    rng = np.random.default_rng(1)
    for _ in range(3):
        legal = env.legal_mask(state).numpy()
        a = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0 for r in legal])
        got = env.step_single(state, _t(a))
        exp = jax.vmap(jenv.step_single)(js, jnp.asarray(a, jnp.int32))
        for name, x, y in zip(BoardState._fields, got, exp):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
    lines = torch.from_numpy(make_lines(env.H, env.W, 3 if env.H == 3 else 4)).long()
    for player in (1, 2):
        p = torch.full((64,), player, dtype=torch.int32)
        exp = jax.vmap(lambda b: jax_would_win(b, jnp.asarray(lines.numpy()), jnp.int32(player)))(
            js.board)
        np.testing.assert_array_equal(would_win(state.board, lines, p).numpy(), np.asarray(exp))


def test_make_lines_is_the_jax_packages():
    for h, w, n in ((3, 3, 3), (6, 7, 4), (9, 9, 5)):
        np.testing.assert_array_equal(make_lines(h, w, n), jax_make_lines(h, w, n))


def _position(env, board, to_play):
    board = torch.tensor([board], dtype=torch.int8)
    return BoardState(board=board, to_play=torch.tensor([to_play], dtype=torch.int32),
                      done=torch.tensor([False]), winner=torch.tensor([0], dtype=torch.int32),
                      t=torch.tensor([int((board != 0).sum())], dtype=torch.int32))


@pytest.mark.parametrize("board,to_play,action,winner", [
    ([1, 1, 0, 2, 2, 0, 0, 0, 0], 1, 2, 1),  # row
    ([2, 1, 1, 2, 1, 0, 0, 0, 0], 2, 6, 2),  # column
    ([1, 2, 0, 2, 1, 0, 0, 0, 0], 1, 8, 1),  # diagonal
    ([1, 2, 1, 1, 2, 2, 2, 1, 0], 1, 8, 0),  # full board: a draw
])
def test_tictactoe_wins_and_draw(board, to_play, action, winner):
    env, jenv = TicTacToeEnv(), JaxTicTacToe()
    s = _position(env, board, to_play)
    ns = env.step_single(s, torch.tensor([action]))
    exp = jenv.step_single(jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()[0]), s),
                           jnp.asarray(action))
    assert bool(ns.done[0]) and int(ns.winner[0]) == winner == int(exp.winner)


def test_tictactoe_bot_wins_then_blocks_and_selfplay_resets():
    env = TicTacToeEnv()
    noise = torch.zeros((1, 9))
    assert int(env.bot_action(_position(env, [1, 1, 0, 2, 0, 0, 0, 0, 0], 2), noise)) == 2
    assert int(env.bot_action(_position(env, [1, 1, 0, 2, 2, 0, 0, 0, 0], 2), noise)) == 5
    s = _position(env, [1, 1, 0, 2, 2, 0, 0, 0, 0], 1)
    step = env.transition(s, torch.tensor([2]), noise)
    assert bool(step.done[0]) and float(step.reward[0]) == 1.0
    assert int(step.state.board.sum()) == 0 and int(step.to_play[0]) == 1
    obs = env.observation(_position(env, [1, 2, 0, 0, 0, 0, 0, 0, 0], 2))[0].numpy()
    assert obs[0, 0, 0] == 0 and obs[0, 1, 0] == 1 and obs[0, 0, 1] == 1 and obs[0, 0, 2] == 0


def test_connect4_gravity_win_block_and_full_column():
    env = Connect4Env()
    s = env.init_state(1, "cpu")
    for _ in range(3):
        s = env.step_single(s, torch.tensor([0]))
        s = env.step_single(s, torch.tensor([6]))
    assert not bool(s.done[0])
    s = env.step_single(s, torch.tensor([0]))
    assert bool(s.done[0]) and int(s.winner[0]) == 1
    grid = s.board.reshape(6, 7).numpy()
    assert (grid[:4, 0] == 1).all() and grid[4, 0] == 0
    s = env.init_state(1, "cpu")
    for c in (0, 6, 1, 6, 2):
        s = env.step_single(s, torch.tensor([c]))
    assert int(s.to_play[0]) == 2
    assert int(env.bot_action(s, torch.zeros((1, 7)))) == 3
    s = env.init_state(1, "cpu")
    for _ in range(6):
        s = env.step_single(s, torch.tensor([3]))
    legal = env.legal_mask(s)[0]
    assert not legal[3] and legal[0]


def test_battle_mode_is_checked():
    with pytest.raises(ValueError, match="battle_mode"):
        TicTacToeEnv(battle_mode="bot")
