"""The grid configs through the port's entry on the CPU.

- The six grid configs in lightzero_tpu_torch/configs/ equal the zoo files,
  key for key.
- Each runs through ``train_muzero`` shrunk: 4 simulations, batch 8,
  16-step episodes (the env's ``max_steps``), 2 collect and 2 eval envs,
  8 channels and a 64-wide projector: losses finite, the learn steps taken,
  the exp dir written; conv MuZero's and conv EfficientZero's searches and
  learn steps on the CPU.
- ``eval_muzero`` plays a checkpoint of such a run and writes nothing, and
  MuZero-Context runs its stateful collect and eval on a conv model.
"""
import importlib
import os

import numpy as np
import pytest
import torch

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import eval_muzero, train_muzero
from lightzero_tpu_torch.policy import MuZeroContextPolicy

pytestmark = pytest.mark.unittest

CONFIGS = {
    "breakout_grid_muzero": "zoo.breakout_grid.config.breakout_grid_muzero_config",
    "breakout_grid_efficientzero": "zoo.breakout_grid.config.breakout_grid_efficientzero_config",
    "asterix_grid_muzero": "zoo.minatar.config.asterix_muzero_config",
    "freeway_grid_muzero": "zoo.minatar.config.freeway_muzero_config",
    "seaquest_grid_muzero": "zoo.minatar.config.seaquest_muzero_config",
    "space_invaders_grid_efficientzero": "zoo.minatar.config.space_invaders_efficientzero_config",
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(name):
    return importlib.import_module(f"lightzero_tpu_torch.configs.{name}").main_config


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grid_config_equals_the_zoo_file(name):
    zoo = importlib.import_module(CONFIGS[name]).main_config
    assert port_config(name).to_dict() == zoo.to_dict()


def shrunk(name, exp_dir, **policy):
    cfg = Config(port_config(name).to_dict())
    cfg.exp_name = str(exp_dir)
    cfg.env = Config(dict(cfg.env, max_steps=16, collector_env_num=2, evaluator_env_num=2,
                          n_evaluator_episode=2, stop_value=10_000))
    model = dict(cfg.policy.model, num_channels=8, proj_hid=64, proj_out=64, pred_hid=32,
                 pred_out=64)
    if "lstm_hidden_size" in model:
        model["lstm_hidden_size"] = 16
    cfg.policy = Config(dict(cfg.policy, model=model, num_simulations=4, batch_size=8,
                             update_per_collect=2, n_episode=2, eval_freq=1000, **policy))
    return cfg


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grid_config_trains_shrunk_through_the_port(tmp_path, name):
    cfg = shrunk(name, tmp_path / "exp")
    policy, state, stats = train_muzero(cfg, seed=0, max_train_iter=2, device="cpu")
    assert stats["train_iter"] == 2 == state.train_iter
    assert stats["eval_env_steps"] > 0 and stats["buffer"].num_transitions >= 8
    obs_shape = tuple(cfg.policy.model.observation_shape)
    assert stats["buffer"]._episodes[0].obs.shape[1:] == obs_shape
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    with open(tmp_path / "exp" / "log" / "train.txt") as f:
        losses = [float(line.split("loss=")[1].split()[0]) for line in f if "loss=" in line]
    assert losses and np.isfinite(losses).all()
    assert os.path.exists(tmp_path / "exp" / "ckpt" / "ckpt_final.pt")
    assert state.model.model_type == "conv"


def test_eval_muzero_plays_a_checkpoint_and_writes_nothing(tmp_path):
    cfg = shrunk("space_invaders_grid_efficientzero", tmp_path / "exp")
    _, state, _ = train_muzero(cfg, seed=0, max_train_iter=2, device="cpu")
    ckpt = str(tmp_path / "exp" / "ckpt" / "ckpt_final")
    before = sorted(os.listdir(tmp_path))
    cfg.exp_name = str(tmp_path / "never_written")
    results = [eval_muzero(cfg, seed=3, model_path=ckpt, n_episodes=2, device="cpu")
               for _ in range(2)]
    assert sorted(os.listdir(tmp_path)) == before
    first, again = results
    assert len(first["episode_returns"]) >= 2 and np.isfinite(first["mean_return"])
    assert first["episode_returns"] == again["episode_returns"]  # deterministic
    # the checkpoint is read: a model of another width does not take it
    cfg.policy.model.num_channels = 4
    with pytest.raises(RuntimeError, match="size mismatch"):
        eval_muzero(cfg, seed=3, model_path=ckpt, n_episodes=2, device="cpu")


def test_muzero_context_collects_and_evaluates_on_a_conv_model(tmp_path):
    """The context's latent is the conv latent (B, h, w, C), rolled through
    the dynamics and reset per env."""
    cfg = shrunk("breakout_grid_muzero", tmp_path / "exp", type="muzero_context")
    policy, state, stats = train_muzero(cfg, seed=0, max_train_iter=2, device="cpu")
    assert isinstance(policy, MuZeroContextPolicy) and stats["train_iter"] == 2
    ctx = policy.init_collect_state(3)
    assert ctx["latent"].shape == (3, 10, 10, 8)
    obs = torch.zeros((3, 10, 10, 4))
    legal = torch.ones((3, 3), dtype=torch.bool)
    to_play = torch.full((3,), -1, dtype=torch.int32)
    out, ctx = policy._forward_collect_stateful(obs, legal, to_play, 1.0, 0.0, ctx,
                                                deterministic=True)
    encoded = policy.model.representation(obs)
    torch.testing.assert_close(ctx["latent"], encoded)  # step 0 encodes
    out, ctx2 = policy._forward_collect_stateful(obs, legal, to_play, 1.0, 0.0, ctx,
                                                 deterministic=True)
    rolled, _ = policy.model.dynamics(ctx["latent"], ctx["last_action"])
    torch.testing.assert_close(ctx2["latent"], rolled)  # step 1 rolls the context
    reset = policy.reset_collect_state(ctx2, torch.tensor([True, False, False]))
    assert not reset["latent"][0].any() and reset["last_action"][0] == -1
