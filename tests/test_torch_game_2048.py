"""Port vs JAX: 2048 (lightzero_tpu_torch/envs/game_2048.py against
lightzero_tpu/envs/game_2048.py).

- The slide, its reward and the legal mask on 1,024 numpy-seeded boards x
  4 moves: exactly equal. The JAX functions are compiled once each, under
  one jax.jit(jax.vmap(...)) (tests/test_game_2048.py compiles per board
  and is marked slow for it).
- A rollout of 64 envs for 60 steps with auto-reset and truncation at 25
  steps, the port's spawn driven with the JAX env's draws (the cell and the
  4-or-2 draw rebuilt from each step's key as the JAX env draws them) and
  the JAX env's reset states: boards, rewards, chance codes, done,
  truncated and legal masks exactly equal. Two spawns on an empty board from
  the JAX reset's draws give the JAX reset board.
- The port's own draw over 24,000 spawns on boards with 1, 5 and 14 empty
  cells: never on an occupied cell; each empty cell's share within 5
  standard deviations of uniform, and the share of 4s within 5 standard
  deviations of 0.1 (binomial standard deviations, so a correct draw fails
  one of these 21 checks with probability below 1e-5).
- The collector stores the env's chance codes: a replay of the same actions
  from the same generator gives the codes of the stored episodes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.envs.game_2048 import Game2048Env as JaxGame2048
from lightzero_tpu.envs.game_2048 import _slide_board as jax_slide_board
from lightzero_tpu_torch.envs.game_2048 import (
    G2048State,
    Game2048Env,
    draw_spawn,
    legal_moves,
    slide_board,
    spawn,
    transition,
)
from lightzero_tpu_torch.workers import RolloutCollector

pytestmark = pytest.mark.unittest


def random_boards(rng, n):
    """Boards with 0-15 empty cells and runs of equal tiles (exponents 0-6,
    so merges are frequent), some full and some without a legal move."""
    boards = rng.integers(0, 7, (n, 4, 4)).astype(np.int32)
    empty = rng.random((n, 1, 1)) * rng.random((n, 4, 4)) < 0.3
    boards[empty] = 0
    # full boards with no move: a checkerboard of distinct neighbours
    boards[: n // 16] = np.where(np.indices((4, 4)).sum(0) % 2 == 0, 1, 2) + (
        np.arange(4)[None, :, None] * 2)
    return boards


def test_slide_reward_and_legal_mask_match_jax():
    rng = np.random.default_rng(0)
    n = 1024
    boards = random_boards(rng, n)
    jenv = JaxGame2048()
    jslide = jax.jit(jax.vmap(jax.vmap(jax_slide_board, (None, 0)), (0, None)))
    jlegal = jax.jit(jax.vmap(jenv._legal))
    exp_boards, exp_rewards = jslide(jnp.asarray(boards), jnp.arange(4))
    exp_legal = np.asarray(jlegal(jnp.asarray(boards)))
    b = torch.from_numpy(boards)
    for d in range(4):
        got_board, got_reward = slide_board(b, torch.full((n,), d))
        np.testing.assert_array_equal(got_board.numpy(), np.asarray(exp_boards[:, d]), err_msg=d)
        np.testing.assert_array_equal(got_reward.numpy(), np.asarray(exp_rewards[:, d]), err_msg=d)
    np.testing.assert_array_equal(legal_moves(b).numpy(), exp_legal)
    # the boards reach every case: merges, no-op moves and dead boards
    assert (np.asarray(exp_rewards) > 0).mean() > 0.2
    assert (~exp_legal).any(axis=1).mean() > 0.05 and (~exp_legal.any(axis=1)).sum() >= n // 16


def _jax_spawn_draws(board, rng):
    """The (cell, is_four) that Game2048Env._spawn draws from ``rng``."""
    cell_rng, val_rng = jax.random.split(rng)
    logits = jnp.where(board.reshape(-1) == 0, 0.0, -jnp.inf)
    return jax.random.categorical(cell_rng, logits), jax.random.uniform(val_rng) < 0.1


def _jax_step_draws(board, action, rng):
    """The step's spawn draws: its key is split into the spawn's and the
    reset's (game_2048.py:133)."""
    slid, _ = jax_slide_board(board, action)
    spawn_rng, _ = jax.random.split(rng)
    return _jax_spawn_draws(slid, spawn_rng)


def _port_state(s):
    return G2048State(*(torch.from_numpy(np.array(x)) for x in s))


def test_reset_from_the_jax_draws_matches_jax():
    jenv = JaxGame2048()
    keys = jax.random.split(jax.random.PRNGKey(1), 32)
    exp, exp_obs = jax.vmap(jenv.reset)(keys)

    def draws(rng):
        r1, r2 = jax.random.split(rng)
        empty = jnp.zeros((4, 4), jnp.int32)
        c1, f1 = _jax_spawn_draws(empty, r1)
        # the second draw sees the first tile, whatever it is
        board = empty.reshape(-1).at[c1].set(1).reshape(4, 4)
        c2, f2 = _jax_spawn_draws(board, r2)
        return c1, f1, c2, f2

    c1, f1, c2, f2 = (torch.from_numpy(np.array(x)) for x in jax.vmap(draws)(keys))
    board = torch.zeros((32, 4, 4), dtype=torch.int32)
    board, code1 = spawn(board, c1, f1)
    board, _ = spawn(board, c2, f2)
    np.testing.assert_array_equal(board.numpy(), np.asarray(exp.board))
    np.testing.assert_array_equal(code1.numpy(), c1.numpy() * 2 + f1.numpy())
    assert ((board > 0).sum((1, 2)) == 2).all()


def test_rollout_with_spawns_auto_reset_and_truncation_matches_jax():
    num, steps, horizon = 64, 60, 25
    jenv = JaxGame2048(max_episode_steps=horizon)
    jstep = jax.jit(jax.vmap(jenv.step))
    jdraws = jax.jit(jax.vmap(_jax_step_draws))
    jreset = jax.jit(jax.vmap(jenv.reset))
    jlegal = jax.jit(jax.vmap(jenv._legal))
    rng = np.random.default_rng(2)
    jstate, _ = jreset(jax.random.split(jax.random.PRNGKey(2), num))
    # episodes start at different step counts so that truncations spread out
    jstate = jstate._replace(t=jnp.asarray(rng.integers(0, horizon, num), jnp.int32))
    pstate = _port_state(jstate)
    key = jax.random.PRNGKey(3)
    seen = dict(truncated=0, dead=0, codes=set(), fours=0, noop=0)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, num)
        legal = np.asarray(jlegal(jstate.board))
        # mostly legal moves, and some that change nothing
        action = np.where(rng.random(num) < 0.9,
                          np.argmax(rng.random((num, 4)) * legal, axis=1),
                          rng.integers(0, 4, num)).astype(np.int32)
        exp = jstep(jstate, jnp.asarray(action), keys)
        cell, four = jdraws(jstate.board, jnp.asarray(action), keys)
        reset_keys = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
        reset_state, _ = jreset(reset_keys)
        got = transition(pstate, torch.from_numpy(action).long(),
                         torch.from_numpy(np.array(cell)), torch.from_numpy(np.array(four)),
                         _port_state(reset_state), max_episode_steps=horizon)
        for name, g, e in (("board", got.state.board, exp.state.board),
                           ("score", got.state.score, exp.state.score),
                           ("t", got.state.t, exp.state.t), ("obs", got.obs, exp.obs),
                           ("reward", got.reward, exp.reward), ("done", got.done, exp.done),
                           ("truncated", got.truncated, exp.truncated),
                           ("legal", got.legal_mask, exp.legal_mask),
                           ("chance", got.chance, exp.chance)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=name)
        moved = np.asarray(exp.chance) > 0
        seen["truncated"] += int(np.asarray(exp.truncated).sum())
        seen["dead"] += int((np.asarray(exp.done) & ~np.asarray(exp.truncated)).sum())
        seen["codes"] |= set(np.asarray(exp.chance)[moved].tolist())
        seen["fours"] += int((np.asarray(exp.chance)[moved] % 2).sum())
        seen["noop"] += int((~legal[np.arange(num), action]).sum())
        jstate, pstate = exp.state, _port_state(exp.state)
    assert seen["truncated"] > 0 and seen["noop"] > 0 and seen["fours"] > 0
    assert len(seen["codes"]) > 20


def test_spawn_draw_frequencies():
    n = 24_000
    boards = np.ones((3, 4, 4), np.int32)
    empties = [[7], [0, 3, 5, 10, 15], list(set(range(16)) - {2, 9})]
    for b, cells in zip(boards, empties):
        b.reshape(-1)[cells] = 0
    board = torch.from_numpy(np.repeat(boards, n // 3, axis=0))
    cell, is_four = draw_spawn(board, torch.Generator().manual_seed(0))
    cell, is_four = cell.numpy(), is_four.numpy()
    p4 = is_four.mean()
    assert abs(p4 - 0.1) <= 5 * np.sqrt(0.1 * 0.9 / n), p4
    for i, cells in enumerate(empties):
        got = cell[i * n // 3:(i + 1) * n // 3]
        assert set(got.tolist()) <= set(cells)
        m, k = got.size, len(cells)
        for c in cells:
            share = (got == c).mean()
            assert abs(share - 1 / k) <= 5 * np.sqrt((1 / k) * (1 - 1 / k) / m) + 1e-12, (i, c)


def test_env_resets_itself_and_truncates():
    env = Game2048Env(max_episode_steps=3)
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(8, g)
    assert obs.shape == (8, 4, 4, 16) and (obs.sum(-1) == 1).all()
    assert ((state.board > 0).sum((1, 2)) == 2).all()
    for _ in range(3):
        legal = env.legal_mask(state)
        step = env.step(state, torch.argmax(legal.to(torch.int8), dim=1), g)
        state = step.state
    assert step.done.all() and step.truncated.all() and (step.state.t == 0).all()
    assert ((step.state.board > 0).sum((1, 2)) == 2).all()
    assert step.chance.dtype == torch.int64 and (step.chance >= 0).all() and (step.chance < 32).all()


class _FirstLegal:
    """Plays the first legal move (so that the replay below can repeat it)."""

    def _forward_collect(self, obs, legal, to_play, temperature, epsilon, deterministic=False):
        B = obs.shape[0]
        return dict(action=torch.argmax(legal.to(torch.int8), dim=1),
                    visit_counts=legal.to(torch.float32),
                    searched_value=torch.zeros(B), predicted_value=torch.zeros(B))


def test_collector_stores_the_envs_chance_codes():
    env = Game2048Env(max_episode_steps=6)
    collector = RolloutCollector(env, _FirstLegal(), num_envs=3, rollout_length=13, seed=4,
                                 device="cpu")
    episodes, _, _ = collector.collect(num_episodes=4)
    g = torch.Generator().manual_seed(4)
    state, _ = env.reset(3, g)
    codes = [[] for _ in range(3)]
    done_codes = []
    for _ in range(13):
        step = env.step(state, torch.argmax(env.legal_mask(state).to(torch.int8), dim=1), g)
        for e in range(3):
            codes[e].append(int(step.chance[e]))
            if step.done[e]:
                done_codes.append(codes[e])
                codes[e] = []
        state = step.state
    stored = [ep.chance.tolist() for ep in episodes]
    assert sorted(stored) == sorted(done_codes) and len(stored) >= 4
    assert any(c % 2 for ep in stored for c in ep) and all(ep.chance.dtype == np.int64
                                                             for ep in episodes)
