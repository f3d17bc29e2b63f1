"""UniZero and Sampled UniZero through the port's training entry on the CPU:

- each ported config (``configs/cartpole_unizero``, ``breakout_grid_unizero``,
  ``breakout_grid_unizero_ws``, ``memory_unizero``,
  ``pendulum_sampled_unizero``) equals its zoo file key for key, and the ws
  config merged with the policy's defaults is the policy of the committed
  run ``data_uz/breakout_grid_unizero_ws2_seed0/total_config.json``;
- each config, shrunk (embed 16-32, 4 simulations, batches of 8, short
  episodes), trains through ``train_unizero`` (an alias of
  ``train_muzero``) for 2 learn steps with an eval, through the stateful
  collector and evaluator: finite params, the exp dir's logs; the CartPole
  run with ``reanalyze_ratio`` 0.5, whose reanalyze roots are prefills of
  the stored history;
- UniZero and discrete Sampled UniZero on a TicTacToe bot-mode config (the
  JAX entry runs both there, with ``downsample=False``);
- the entry aliases, and the refusals: the multitask types (which train
  through the multitask entries, and fail in JAX's train_muzero), the
  LPIPS loss (item 20), another optimizer than AdamW, and no CUDA device
  without ``device=``.
"""
import copy
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu_torch import entry
from lightzero_tpu_torch.config import Config, deep_merge
from lightzero_tpu_torch.entry import train_muzero
from lightzero_tpu_torch.policy import SampledUniZeroPolicy, UniZeroPolicy

pytestmark = pytest.mark.unittest

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = {
    "cartpole_unizero": "classic_control.cartpole.config.cartpole_unizero_config",
    "breakout_grid_unizero": "breakout_grid.config.breakout_grid_unizero_config",
    "breakout_grid_unizero_ws": "breakout_grid.config.breakout_grid_unizero_ws_config",
    "memory_unizero": "memory.config.memory_unizero_config",
    "pendulum_sampled_unizero": "classic_control.pendulum.config.pendulum_sampled_unizero_config",
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(name):
    return importlib.import_module(f"lightzero_tpu_torch.configs.{name}").main_config


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_is_the_zoo_config(name):
    zoo = importlib.import_module(f"zoo.{CONFIGS[name]}").main_config
    assert port_config(name).to_dict() == JaxConfig(zoo).to_dict()


def test_ws_config_is_the_committed_runs_policy():
    with open(REPO / "data_uz/breakout_grid_unizero_ws2_seed0/total_config.json") as f:
        committed = json.load(f)["policy"]
    merged = deep_merge(UniZeroPolicy.default_config(), port_config("breakout_grid_unizero_ws").policy)
    merged = json.loads(json.dumps(merged.to_dict()))  # tuples as JSON lists
    assert merged == committed


SHRINK = {
    "cartpole_unizero": dict(env=dict(max_episode_steps=12), policy=dict(reanalyze_ratio=0.5)),
    "breakout_grid_unizero": dict(env=dict(max_steps=12),
                                  policy=dict(model=dict(num_channels=4))),
    "breakout_grid_unizero_ws": dict(env=dict(max_steps=12),
                                     policy=dict(model=dict(num_channels=4),
                                                 train_start_after_envsteps=0, replay_ratio=None,
                                                 auto_resume=False)),
    "memory_unizero": dict(env=dict(env_kwargs=dict(num_cues=4, memory_length=2)),
                           policy=dict(num_unroll_steps=4, td_steps=4)),
    "pendulum_sampled_unizero": dict(env=dict(max_episode_steps=12, stop_value=1e9),
                                     policy=dict(num_of_sampled_actions=3)),
}


def shrunk(name, exp_dir):
    cfg = copy.deepcopy(port_config(name))
    cfg.exp_name = str(exp_dir)
    cfg.env.update(collector_env_num=2, evaluator_env_num=2, n_evaluator_episode=2)
    cfg.policy.model.update(embed_dim=16, num_heads=2, max_tokens=12)
    cfg.policy.update(num_simulations=4, batch_size=8, update_per_collect=2, n_episode=2,
                      eval_freq=1000)
    cfg = deep_merge(cfg, SHRINK[name])
    if cfg.policy.get("replay_ratio", 1) is None:
        cfg.policy.pop("replay_ratio")
    return cfg


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_unizero_trains_each_config_shrunk(tmp_path, name):
    cfg = shrunk(name, tmp_path / "exp")
    policy, state, stats = entry.train_unizero(cfg, seed=0, max_train_iter=2, device="cpu")
    cls = SampledUniZeroPolicy if name.startswith("pendulum") else UniZeroPolicy
    assert type(policy) is cls
    assert stats["train_iter"] == 2 == state.train_iter
    assert stats["eval_env_steps"] > 0
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    logs = (tmp_path / "exp" / "log" / "train.jsonl").read_text().splitlines()
    losses = [json.loads(line)["learner/total_loss"] for line in logs
              if "learner/total_loss" in line]
    assert losses and all(np.isfinite(losses))
    ep = stats["buffer"]._episodes[0]
    if name.startswith("pendulum"):
        assert ep.root_sampled_actions.shape[1:] == (3, 1) and ep.actions.dtype == np.float32
    if name == "breakout_grid_unizero":
        assert hasattr(policy.model, "decoder_out")  # latent_recon_loss_weight builds it


def test_reanalyze_roots_are_prefills_of_the_stored_history(tmp_path):
    cfg = shrunk("cartpole_unizero", tmp_path / "exp")
    policy, state, stats = train_muzero(cfg, seed=0, max_train_iter=1, device="cpu")
    seen = []
    prefill = state.target_model.prefill

    def spy(obs_hist, act_hist, hist_len, task_id=None):
        seen.append((obs_hist.shape, hist_len.clone()))
        return prefill(obs_hist, act_hist, hist_len, task_id)

    state.target_model.prefill = spy
    batch, _ = stats["buffer"].sample(8, state.target_model)
    (shape, hist_len), = seen
    assert shape == (4 * 6, 5, 4)  # ceil(8 x 0.5) samples x (K + 1) roots, H + 1 = 5 obs
    assert int(hist_len.max()) <= 4 and bool((hist_len >= 0).all())
    assert torch.isfinite(batch.target_policy).all()


@pytest.mark.parametrize("policy_type", ["unizero", "sampled_unizero"])
def test_unizero_trains_on_a_board_game(tmp_path, policy_type):
    cfg = Config(dict(
        exp_name=str(tmp_path / "exp"),
        env=dict(env_id="tictactoe", battle_mode="play_with_bot_mode", collector_env_num=2,
                 evaluator_env_num=1),
        policy=dict(type=policy_type, env_type="board_games", battle_mode="play_with_bot_mode",
                    model=dict(observation_shape=(3, 3, 3), action_space_size=9, embed_dim=16,
                               num_heads=2, num_layers=1, max_tokens=8, support_scale=5,
                               num_channels=4, downsample=False, continuous_action_space=False),
                    num_of_sampled_actions=3, num_simulations=3, batch_size=4,
                    update_per_collect=1, n_episode=2, eval_freq=1000)))
    policy, state, stats = train_muzero(cfg, seed=0, max_train_iter=1, device="cpu")
    assert policy.players == 2 and stats["train_iter"] == 1
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_entry_aliases():
    assert entry.train_unizero is train_muzero
    assert entry.train_unizero_segment is train_muzero
    assert entry.eval_unizero is entry.eval_muzero


# the lpips case was refused until slice 21: the perceptual term is built
# and, on CartPole's vector observations, left out of the loss as in JAX
@pytest.mark.parametrize("override,error,match", [
    (dict(type="unizero_multitask"), ValueError, "train_muzero_multitask"),
    (dict(type="sampled_unizero_multitask"), ValueError, "train_muzero_multitask"),
    (dict(perceptual_loss_weight=0.5, latent_recon_loss_weight=0.1), None, None),
    (dict(optim_type="Adam"), NotImplementedError, "AdamW"),
], ids=["multitask", "sampled_multitask", "lpips", "adam"])
def test_train_unizero_refuses_what_is_not_ported(tmp_path, override, error, match):
    cfg = shrunk("cartpole_unizero", tmp_path / "exp")
    cfg.policy.update(override)
    if error is None:
        policy, state, stats = entry.train_unizero(cfg, device="cpu", max_train_iter=1)
        assert policy.lpips is not None and stats["train_iter"] >= 1
        assert all(torch.isfinite(p).all() for p in state.model.parameters())
        return
    with pytest.raises(error, match=match):
        entry.train_unizero(cfg, device="cpu")


def test_unizero_config_raises_with_no_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.train_unizero(shrunk("cartpole_unizero", tmp_path / "exp"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UniZeroPolicy(port_config("cartpole_unizero").policy)
