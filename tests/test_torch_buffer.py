"""Port vs JAX: the replay buffer (lightzero_tpu_torch/buffers against
lightzero_tpu/buffers/game_buffer.py), native and Python paths.

The same numpy-seeded episodes and priorities go into both buffers, each
with its policy holding the same flax params (small widths, support scale
10). Both draw from RandomState(seed + 4096) in the same order, so:
- the sampled indices are equal and the importance weights equal (the same
  float64 arithmetic; the native cores are the same source built by the
  same g++);
- every batch field agrees to 1e-6, except the value targets, which hold
  the target net's bootstrap values: 1e-5 (the model's float32 sums in
  another order, through the inverse value transform);
- after update_priority with the same priorities the next sample is equal;
- at reanalyze_ratio=0.25 with reanalyze_noise=False and tie_break='first'
  the reanalyzed policy targets are equal: the searches are deterministic
  and their visit counts exact (tests/test_torch_policy.py).
"""
import dataclasses
import pathlib
import re

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
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from test_torch_learn import SMALL
from test_torch_model import perturbed_params

pytestmark = pytest.mark.unittest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once: their thread pools would
    fight over the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = pathlib.Path(__file__).resolve().parent.parent
BATCH = 16
FIELDS = ("obs", "actions", "mask", "target_reward", "target_policy", "weights", "chance")


def random_episodes(seed, n=7, A=2):
    """Episodes of 3 to 40 steps, some truncated, with normalized visit
    distributions and a priority vector for every other episode."""
    rng = np.random.default_rng(seed)
    episodes, priorities = [], []
    for i in range(n):
        T = int(rng.integers(3, 41))
        visits = rng.integers(0, 6, (T, A)).astype(np.float32)
        visits[:, 0] += 1
        fields = dict(
            obs=rng.standard_normal((T, 4)).astype(np.float32),
            actions=rng.integers(0, A, T).astype(np.int64),
            rewards=rng.uniform(0, 2, T).astype(np.float32),
            child_visits=visits / visits.sum(-1, keepdims=True),
            root_values=rng.standard_normal(T).astype(np.float32),
            legal_mask=np.ones((T, A), bool),
            to_play=np.full(T, -1, np.int64),
            truncated=bool(i % 3 == 0),
            chance=np.zeros(T, np.int64),
        )
        episodes.append(fields)
        priorities.append(rng.uniform(0.1, 3.0, T) if i % 2 else None)
    return episodes, priorities


@pytest.fixture(scope="module")
def policies():
    cfg = jax_deep_merge(JaxMuZeroPolicy.default_config(), SMALL)
    jax_policy = JaxMuZeroPolicy(jax_deep_merge(cfg, dict(reanalyze_noise=False)))
    jax_policy.search_cfg = dataclasses.replace(jax_policy.search_cfg, tie_break="first")
    params = jax.tree_util.tree_map(jnp.asarray, perturbed_params(jax_policy.model, 4))
    port = MuZeroPolicy(dict(SMALL, reanalyze_noise=False), device="cpu")
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    port.search_cfg = dataclasses.replace(port.search_cfg, tie_break="first")
    return jax_policy, params, port


def make_buffers(policies, **override):
    jax_policy, _, port = policies
    cfg = dict(SMALL, seed=3, batch_size=BATCH, **override)
    jax_buf = JaxGameBuffer(jax_deep_merge(jax_policy.cfg, cfg), jax_policy)
    buf = GameBuffer(jax_deep_merge(port.cfg, cfg), port)
    episodes, priorities = random_episodes(5)
    jax_buf.push_episodes([JaxEpisodeRecord(**e) for e in episodes], priorities)
    buf.push_episodes([EpisodeRecord(**e) for e in episodes], priorities)
    return jax_buf, buf


def check_batches(got, exp):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(exp, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(got.target_value.numpy(), np.asarray(exp.target_value),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_samples_match_jax(policies, use_native):
    _, params, port = policies
    jax_buf, buf = make_buffers(policies, use_native_replay=use_native)
    assert jax_buf._use_native == buf._use_native == use_native
    assert buf.num_transitions == jax_buf.num_transitions
    target = port.model  # the same params as the JAX target
    rng = np.random.default_rng(9)
    for round_ in range(3):
        exp, exp_idx = jax_buf.sample(BATCH, params)
        got, idx = buf.sample(BATCH, target)
        np.testing.assert_array_equal(idx, exp_idx, err_msg=f"round {round_}")
        check_batches(got, exp)
        assert got.mask.sum() > 0 and (got.mask == 0).any()  # episodes end inside unrolls
        new_p = rng.uniform(0.01, 5.0, BATCH)
        jax_buf.update_priority(exp_idx, new_p)
        buf.update_priority(idx, new_p)
        np.testing.assert_array_equal(buf._flat_priorities, jax_buf._flat_priorities)


def test_reanalyze_targets_match_jax(policies):
    _, params, port = policies
    jax_buf, buf = make_buffers(policies, reanalyze_ratio=0.25)
    for _ in range(2):  # the second sample reuses the reanalyze generator
        exp, exp_idx = jax_buf.sample(BATCH, params)
        got, idx = buf.sample(BATCH, port.model)
        np.testing.assert_array_equal(idx, exp_idx)
        check_batches(got, exp)
    n_re = int(np.ceil(BATCH * 0.25))
    # the first n_re rows hold visit counts of 5 simulations, the rest the
    # stored distributions
    counts = got.target_policy.numpy() * 5
    assert np.allclose(counts[:n_re], np.round(counts[:n_re]), atol=1e-5)
    assert not np.allclose(counts[n_re:], np.round(counts[n_re:]), atol=1e-5)


def test_buffer_evicts_the_oldest_episodes_as_jax(policies):
    jax_buf, buf = make_buffers(policies, replay_buffer_size=60)
    assert buf.num_episodes < 7 and buf.num_transitions <= 60
    assert (buf.num_episodes, buf.num_transitions) == (jax_buf.num_episodes, jax_buf.num_transitions)
    for got, exp in zip(buf._episodes, jax_buf._episodes):
        np.testing.assert_array_equal(got.obs, exp.obs)


def _code(path):
    """The source without comments and blank lines."""
    text = re.sub(r"//[^\n]*", "", path.read_text())
    return [line.rstrip() for line in text.splitlines() if line.strip()]


def test_replay_core_is_the_jax_packages_code():
    assert _code(REPO / "lightzero_tpu_torch/csrc/replay_core.cpp") == _code(
        REPO / "lightzero_tpu/buffers/native/replay_core.cpp")


def test_refuses_unported_modes(policies):
    jax_policy, _, port = policies
    # board-game targets and mirror augmentation are ported
    # (tests/test_torch_board_buffer.py holds them against JAX): the modes
    # are read from the config as the JAX buffer reads them
    for override in (dict(env_type="board_games"), dict(mirror_augmentation=True),
                     dict(env_type="board_games", battle_mode="self_play_mode")):
        jax_buf = JaxGameBuffer(jax_deep_merge(jax_policy.cfg, override), jax_policy)
        buf = GameBuffer(jax_deep_merge(port.cfg, override), port)
        assert ((buf.board_mode, buf.winner_z_targets, buf.mirror_augmentation)
                == (jax_buf.board_mode, jax_buf.winner_z_targets, jax_buf.mirror_augmentation))
    assert buf.winner_z_targets
    buf = GameBuffer(port.cfg, port)
    # whole-buffer reanalyze is ported (tests/test_torch_rezero.py holds it
    # against JAX): it runs and rewrites the stored targets
    episodes, _ = random_episodes(2, n=2)
    buf.push_episodes([EpisodeRecord(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                                        for k, v in e.items()}) for e in episodes])
    n = buf.reanalyze_buffer(port.model, reanalyze_batch_size=8, partition=1.0)
    assert n == buf.num_transitions
    for ep, e in zip(buf._episodes, episodes):
        assert not np.array_equal(ep.child_visits, e["child_visits"])
        np.testing.assert_allclose(ep.child_visits.sum(-1), 1.0, rtol=1e-6)
    buf = GameBuffer(port.cfg, port)
    # float actions (a continuous action space) are accepted since Sampled
    # MuZero is ported (tests/test_torch_sampled.py samples such episodes)
    episodes, _ = random_episodes(1, n=1)
    e = dict(episodes[0], actions=episodes[0]["actions"].astype(np.float32))
    buf.push_episodes([EpisodeRecord(**e)])
    assert buf.num_episodes == 1 and buf._episodes[0].actions.dtype == np.float32
