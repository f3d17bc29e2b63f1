"""Board-game MuZero and EfficientZero through the port's entry on the CPU.

- The five board configs in lightzero_tpu_torch/configs/ equal the zoo
  files, key for key.
- Each runs shrunk through ``train_muzero`` (4 simulations, batch 8, 8
  channels): losses finite, the learn steps taken; self-play episodes carry
  to_play 1 and 2, bot-mode ones -1; Connect4 FT's batches are mirrored.
  Two zoo TicTacToe configs leave ``downsample`` at its default, which
  downsamples the 3x3 board to nothing: the JAX package fails on them while
  it builds the model, and the port refuses them with a ValueError; with
  ``downsample=False`` they train.
- The collector starts self-play roots at the env's player (to_play 1), as
  the JAX collector does; the evaluator keeps -1.
- The committed Connect4 MuZero params (data_mz/connect4_muzero_ft_seed0,
  loaded with the JAX package's orbax reader) go through the conv importer
  as they are; initial and recurrent inference on the port env's
  observations equal flax's to 1e-5.
"""
import importlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.models.muzero import MuZeroModel as JaxMuZeroModel
from lightzero_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import train_muzero
from lightzero_tpu_torch.envs import Connect4Env, TicTacToeEnv
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from lightzero_tpu_torch.workers import Evaluator, RolloutCollector

pytestmark = pytest.mark.unittest

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = {
    "tictactoe_muzero_bot_mode": "zoo.board_games.tictactoe.config.tictactoe_muzero_bot_mode_config",
    "tictactoe_muzero_sp_mode": "zoo.board_games.tictactoe.config.tictactoe_muzero_sp_mode_config",
    "tictactoe_efficientzero_bot_mode":
        "zoo.board_games.tictactoe.config.tictactoe_efficientzero_bot_mode_config",
    "connect4_muzero_bot_mode": "zoo.board_games.connect4.config.connect4_muzero_bot_mode_config",
    "connect4_muzero_ft": "zoo.board_games.connect4.config.connect4_muzero_ft_config",
}
# the zoo configs that leave downsample at its default on a 3x3 board
DOWNSAMPLED_TO_NOTHING = ("tictactoe_muzero_sp_mode", "tictactoe_efficientzero_bot_mode")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(name):
    return importlib.import_module(f"lightzero_tpu_torch.configs.{name}").main_config


@pytest.mark.parametrize("name", list(CONFIGS))
def test_board_config_equals_the_zoo_file(name):
    zoo = importlib.import_module(CONFIGS[name]).main_config
    assert port_config(name).to_dict() == zoo.to_dict()


def shrunk(name, exp_dir, **model):
    cfg = Config(port_config(name).to_dict())
    cfg.exp_name = str(exp_dir)
    cfg.env = Config(dict(cfg.env, collector_env_num=2, evaluator_env_num=2,
                          n_evaluator_episode=2, stop_value=10_000))
    model = dict(cfg.policy.model, num_channels=8, proj_hid=64, proj_out=64, pred_hid=32,
                 pred_out=64, **model)
    if cfg.policy.type == "efficientzero":
        model["lstm_hidden_size"] = 16
    cfg.policy = Config(dict(cfg.policy, model=model, num_simulations=4, batch_size=8,
                             update_per_collect=2, n_episode=2, eval_freq=1000))
    return cfg


@pytest.mark.parametrize("name", list(CONFIGS))
def test_board_config_trains_shrunk_through_the_port(tmp_path, name):
    if name in DOWNSAMPLED_TO_NOTHING:
        with pytest.raises(ValueError, match="downsample"):
            train_muzero(shrunk(name, tmp_path / "refused"), device="cpu")
        cfg = shrunk(name, tmp_path / "exp", downsample=False)
    else:
        cfg = shrunk(name, tmp_path / "exp")
    policy, state, stats = train_muzero(cfg, seed=0, max_train_iter=2, device="cpu")
    assert stats["train_iter"] == 2 == state.train_iter and policy.players == 2
    buf = stats["buffer"]
    assert buf.num_transitions >= 8 and stats["eval_env_steps"] > 0
    players = set(np.concatenate([ep.to_play for ep in buf._episodes]).tolist())
    selfplay = cfg.env.battle_mode == "self_play_mode"
    assert players == ({1, 2} if selfplay else {-1})
    # the buffer reads battle_mode from the policy's config, as the JAX
    # buffer does: the sp-mode config sets it on the env only, so neither
    # package trains it on winner-z targets (ROADMAP queue 3)
    assert not buf.winner_z_targets
    assert buf.mirror_augmentation == (name == "connect4_muzero_ft")
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_collector_starts_self_play_roots_at_the_envs_player():
    policy = MuZeroPolicy(dict(model=dict(observation_shape=(3, 3, 3), action_space_size=9,
                                          model_type="conv", num_channels=4, downsample=False,
                                          support_scale=2),
                               env_type="board_games", num_simulations=3), device="cpu")
    collector = RolloutCollector(TicTacToeEnv("self_play_mode"), policy, 3, rollout_length=4,
                                 device="cpu")
    episodes, _, _ = collector.collect(num_episodes=None)
    (_, _, _, to_play) = collector._state
    assert to_play.tolist() == [1, 1, 1]  # 4 plies in: player 1 to move
    assert set(collector._builders[0].to_play) == {1, 2}
    assert collector._builders[0].to_play[0] == 1
    bot = RolloutCollector(TicTacToeEnv("play_with_bot_mode"), policy, 2, rollout_length=2,
                           device="cpu")
    bot.collect(num_episodes=None)
    assert bot._builders[0].to_play[0] == -1
    evaluator = Evaluator(TicTacToeEnv("self_play_mode"), policy, 2, device="cpu")
    assert evaluator.eval(n_episodes=2)["env_steps"] > 0  # roots at -1, as the JAX evaluator


def test_committed_connect4_params_match_flax_in_the_port():
    run = REPO / "data_mz" / "connect4_muzero_ft_seed0"
    total = json.loads((run / "total_config.json").read_text())
    model_cfg = dict(total["policy"]["model"], observation_shape=(6, 7, 3))
    restored = jax_load_checkpoint(str(run / "ckpt" / "params_best"))
    params = jax.tree_util.tree_map(np.asarray, restored["params"])
    policy = MuZeroPolicy(dict(total["policy"], model=model_cfg), device="cpu")
    port = policy.model
    port.load_state_dict(flax_to_state_dict(params))
    flax_model = JaxMuZeroModel.from_config(JaxConfig(dict(
        model_cfg, value_support_size=policy.value_support.size,
        reward_support_size=policy.reward_support.size)))
    env = Connect4Env("play_with_bot_mode")
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(6, g)
    for _ in range(5):
        legal = env.legal_mask(state).float()
        step = env.step(state, torch.multinomial(legal, 1, generator=g)[:, 0], g)
        state, obs = step.state, step.obs
    action = torch.tensor([0, 1, 2, 3, 4, 6])
    exp0 = flax_model.apply(params, jnp.asarray(obs.numpy()), method=flax_model.initial_inference)
    exp1 = flax_model.apply(params, exp0.latent_state, jnp.asarray(action.numpy(), jnp.int32),
                            method=flax_model.recurrent_inference)
    with torch.no_grad():
        got0 = port.initial_inference(obs)
        got1 = port.recurrent_inference(got0.latent_state, action)
    for got, exp in ((got0, exp0), (got1, exp1)):
        for name in ("value_logits", "reward_logits", "policy_logits", "latent_state"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(exp, name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
