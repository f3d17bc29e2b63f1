"""Port vs JAX: the replay buffer's board-game paths
(lightzero_tpu_torch/buffers/game_buffer.py against
lightzero_tpu/buffers/game_buffer.py) on Connect4 episodes.

The same episodes (numpy-seeded random Connect4 games through the port's
env: 6x7x3 planes, A = 7 columns, to_play alternating 1 and 2 in
self-play, -1 against the bot, some truncated) go into both buffers, each
with a small conv MuZero policy (4 channels, no downsampling, support
scale 10, ``env_type`` board_games) holding the same flax params. Both draw
from RandomState(seed + 4096) in the same order, so sampled indices are
equal, and:
- self-play (``battle_mode`` self_play_mode in the policy's config): the
  value targets are the winner-z targets, exactly; against the bot they are
  the n-step returns with the target net's bootstrap, to 1e-5 (float32
  sums in another order); native and Python paths both;
- reanalyze (ratio 0.25, no root noise, tie_break 'first') searches the
  stored positions with their stored to_play under players == 2: the
  reanalyzed policy targets agree to 1e-6 (the visit counts are exact);
- mirror augmentation: the same coin flips on both sides (the buffer's
  RandomState), so the mirrored batches agree; with flips handed in, the
  mirrored rows are the observations' W axis, the columns and the policy
  targets reversed; the JAX buffer's refusals are kept.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.buffers.game_buffer import EpisodeRecord as JaxEpisodeRecord
from lightzero_tpu.buffers.game_buffer import GameBuffer as JaxGameBuffer
from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.policy.muzero import MuZeroPolicy as JaxMuZeroPolicy
from lightzero_tpu_torch.buffers import EpisodeRecord, GameBuffer
from lightzero_tpu_torch.envs import Connect4Env
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.policy.muzero import TrainBatch
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from test_torch_model import perturbed_params

pytestmark = pytest.mark.unittest

BATCH = 16
FIELDS = ("obs", "actions", "mask", "target_reward", "target_policy", "weights", "chance")
BOARD = dict(
    model=dict(observation_shape=(6, 7, 3), action_space_size=7, model_type="conv",
               num_channels=4, num_res_blocks=1, downsample=False, support_scale=10),
    env_type="board_games", num_simulations=5, num_unroll_steps=3, td_steps=21,
    discount_factor=1.0, reanalyze_noise=False,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def connect4_episodes(seed, mode, n=6):
    """Random Connect4 games through the port's env in ``mode``: each game's
    positions, moves, rewards and players; every third one cut short and
    marked truncated."""
    env = Connect4Env(battle_mode=mode)
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    episodes = []
    for i in range(n):
        state, obs = env.reset(1, g)
        rec = dict(obs=[], actions=[], rewards=[], legal_mask=[], to_play=[])
        while True:
            legal = env.legal_mask(state)[0].numpy()
            a = int(rng.choice(np.flatnonzero(legal)))
            rec["obs"].append(obs[0].numpy())
            rec["legal_mask"].append(legal)
            rec["to_play"].append(int(env.initial_to_play(state)[0]))
            step = env.step(state, torch.tensor([a]), g)
            rec["actions"].append(a)
            rec["rewards"].append(float(step.reward[0]))
            state, obs = step.state, step.obs
            if bool(step.done[0]) or (i % 3 == 0 and len(rec["actions"]) == 7):
                break
        T = len(rec["actions"])
        visits = rng.integers(0, 6, (T, 7)).astype(np.float32) * np.asarray(rec["legal_mask"])
        visits[np.arange(T), rec["actions"]] += 1
        episodes.append(dict(
            obs=np.asarray(rec["obs"], np.float32), actions=np.asarray(rec["actions"], np.int64),
            rewards=np.asarray(rec["rewards"], np.float32),
            child_visits=visits / visits.sum(-1, keepdims=True),
            root_values=rng.standard_normal(T).astype(np.float32),
            legal_mask=np.asarray(rec["legal_mask"], bool),
            to_play=np.asarray(rec["to_play"], np.int64),
            truncated=bool(i % 3 == 0 and not bool(step.done[0])),
            chance=np.zeros(T, np.int64)))
    return episodes


@pytest.fixture(scope="module")
def policies():
    cfg = jax_deep_merge(JaxMuZeroPolicy.default_config(), BOARD)
    jax_policy = JaxMuZeroPolicy(cfg)
    jax_policy.search_cfg = dataclasses.replace(jax_policy.search_cfg, tie_break="first")
    params = jax.tree_util.tree_map(jnp.asarray, perturbed_params(jax_policy.model, 6))
    port = MuZeroPolicy(BOARD, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    port.search_cfg = dataclasses.replace(port.search_cfg, tie_break="first")
    assert port.players == jax_policy.players == 2
    return jax_policy, params, port


def make_buffers(policies, mode, **override):
    jax_policy, _, port = policies
    cfg = dict(BOARD, seed=5, batch_size=BATCH, battle_mode=mode, **override)
    jax_buf = JaxGameBuffer(jax_deep_merge(jax_policy.cfg, cfg), jax_policy)
    buf = GameBuffer(jax_deep_merge(port.cfg, cfg), port)
    episodes = connect4_episodes(len(mode), mode)
    jax_buf.push_episodes([JaxEpisodeRecord(**e) for e in episodes])
    buf.push_episodes([EpisodeRecord(**e) for e in episodes])
    return jax_buf, buf


def check_batches(got, exp, value_tol):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(exp, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(got.target_value.numpy(), np.asarray(exp.target_value),
                               rtol=value_tol, atol=value_tol)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("mode", ["self_play_mode", "play_with_bot_mode"])
def test_value_targets_match_jax(policies, mode, use_native):
    _, params, port = policies
    jax_buf, buf = make_buffers(policies, mode, use_native_replay=use_native)
    assert buf._use_native == use_native
    selfplay = mode == "self_play_mode"
    assert buf.winner_z_targets == jax_buf.winner_z_targets == selfplay
    for _ in range(2):
        exp, exp_idx = jax_buf.sample(BATCH, params)
        got, idx = buf.sample(BATCH, port.model)
        np.testing.assert_array_equal(idx, exp_idx)
        check_batches(got, exp, 0.0 if selfplay else 1e-5)
    if selfplay:
        z = got.target_value.numpy()
        assert set(np.unique(z)) <= {-1.0, 0.0, 1.0} and (z == 1).any() and (z == -1).any()


def test_winner_z_is_the_outcome_from_the_movers_side(policies):
    _, _, port = policies
    buf = GameBuffer(jax_deep_merge(port.cfg, dict(BOARD, battle_mode="self_play_mode")), port)
    T = 5  # player 1 moves at t = 0, 2, 4 and wins with the last move
    ep = dict(obs=np.zeros((T, 6, 7, 3), np.float32), actions=np.zeros(T, np.int64),
              rewards=np.array([0, 0, 0, 0, 1], np.float32),
              child_visits=np.full((T, 7), 1 / 7, np.float32), root_values=np.zeros(T, np.float32),
              legal_mask=np.ones((T, 7), bool), to_play=np.array([1, 2, 1, 2, 1]),
              chance=np.zeros(T, np.int64))
    buf.push_episodes([EpisodeRecord(**ep), EpisodeRecord(**dict(ep, truncated=True))])
    buf._rebuild_flat()
    z = buf._board_game_value_targets(np.array([0, 3, 5]))
    np.testing.assert_array_equal(z, [[1, -1, 1, -1], [-1, 1, 0, 0], [0, 0, 0, 0]])


def test_reanalyze_searches_with_the_stored_players(policies, monkeypatch):
    _, params, port = policies
    jax_buf, buf = make_buffers(policies, "self_play_mode", reanalyze_ratio=0.25)
    seen = []
    search = port.forward_reanalyze

    def recording(target_model, obs, legal, to_play=None, **kw):
        seen.append(to_play.clone())
        return search(target_model, obs, legal, to_play, **kw)

    monkeypatch.setattr(port, "forward_reanalyze", recording)
    exp, exp_idx = jax_buf.sample(BATCH, params)
    got, idx = buf.sample(BATCH, port.model)
    np.testing.assert_array_equal(idx, exp_idx)
    check_batches(got, exp, 0.0)
    assert set(seen[0].tolist()) >= {1, 2}  # two-player roots, not -1


def test_mirror_augmentation_matches_jax(policies):
    _, params, port = policies
    jax_buf, buf = make_buffers(policies, "play_with_bot_mode", mirror_augmentation=True,
                                use_priority=False)
    plain_jax, plain = make_buffers(policies, "play_with_bot_mode", use_priority=False)
    mirrored_rows = 0
    for _ in range(2):
        exp, exp_idx = jax_buf.sample(BATCH, params)
        got, idx = buf.sample(BATCH, port.model)
        np.testing.assert_array_equal(idx, exp_idx)
        check_batches(got, exp, 1e-5)
        base, _ = plain.sample(BATCH, port.model)
        plain_jax.sample(BATCH, params)  # keeps the two unmirrored buffers in step
        plain._rng.rand(BATCH)  # the draw of the flips, which the plain buffer skips
        flipped = (got.actions != base.actions).any(1) | (got.obs != base.obs).flatten(1).any(1)
        mirrored_rows += int(flipped.sum())
    assert 0 < mirrored_rows < 2 * BATCH


def test_handed_in_flips_mirror_those_rows(policies):
    _, _, port = policies
    _, buf = make_buffers(policies, "play_with_bot_mode", mirror_augmentation=True)
    _, plain = make_buffers(policies, "play_with_bot_mode")
    flips = np.arange(BATCH) % 2 == 0
    got, _ = buf.sample(BATCH, port.model, flips=flips)
    base, _ = plain.sample(BATCH, port.model)
    f = torch.from_numpy(flips)
    torch.testing.assert_close(got.obs[f], base.obs[f].flip(-2))
    torch.testing.assert_close(got.actions[f], 6 - base.actions[f])
    torch.testing.assert_close(got.target_policy[f], base.target_policy[f].flip(-1))
    torch.testing.assert_close(got.obs[~f], base.obs[~f])
    torch.testing.assert_close(got.target_value, base.target_value)


def test_mirror_augmentation_keeps_the_jax_refusals(policies):
    _, _, port = policies
    buf = GameBuffer(jax_deep_merge(port.cfg, dict(BOARD, mirror_augmentation=True)), port)
    B, K = 2, 3
    batch = TrainBatch(obs=torch.zeros((B, K + 1, 6, 7, 3)), actions=torch.zeros((B, K),
                       dtype=torch.int64), mask=torch.ones((B, K)),
                       target_reward=torch.zeros((B, K)), target_value=torch.zeros((B, K + 1)),
                       target_policy=torch.zeros((B, K + 1, 7)), weights=torch.ones(B),
                       chance=torch.zeros((B, K), dtype=torch.int64))
    with pytest.raises(ValueError, match="chance"):
        buf._mirror_augment(batch._replace(chance=torch.ones((B, K), dtype=torch.int64)))
    with pytest.raises(ValueError, match="board-shaped"):
        buf._mirror_augment(batch._replace(obs=torch.zeros((B, K + 1, 7))))
    with pytest.raises(ValueError, match="column-action"):
        buf._mirror_augment(batch._replace(target_policy=torch.zeros((B, K + 1, 9))))
    with pytest.raises(TypeError):
        buf._mirror_augment(tuple(batch))
