"""The host-env configs through the port (lightzero_tpu_torch/configs/ and
entry/train_muzero.py's host path), and the other zoo configs the port
copies.

- Each copied config equals its zoo file key for key: the 20 host configs
  (LunarLander 11, BipedalWalker 3, MountainCar 1, MuJoCo Hopper-v4 1,
  DMC 4) and the 29 Pendulum, CartPole, 2048, memory and Grid Breakout
  variants.
- The 14 runnable gymnasium configs (LunarLander 9, BipedalWalker 3,
  MountainCar, Hopper-v4), shrunk (4 simulations, batches of 8, 16-step
  episodes, 2 learn steps, small widths), train through the port's
  train_muzero on the CPU: the host collector and evaluator, finite params
  and losses. The DMC configs run in tests/test_torch_host_dmc.py.
- The two configs with env=dict(type="lunarlander") fail in JAX
  (gymnasium raises NameNotFound for the id) and the port refuses them with
  a ValueError that quotes it (ROADMAP queue 3).
"""
import copy
import importlib
import json

import numpy as np
import pytest
import torch

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.entry.train_muzero import make_host_vec_env as jax_make_host_vec_env
from lightzero_tpu_torch.entry import train_muzero

pytestmark = pytest.mark.unittest

HOST = {
    **{name: f"box2d.lunarlander.config.{name}_config" for name in (
        "lunarlander_cont_sampled_efficientzero", "lunarlander_cont_sampled_muzero",
        "lunarlander_cont_sampled_unizero", "lunarlander_disc_efficientzero",
        "lunarlander_disc_gumbel_muzero", "lunarlander_disc_muzero", "lunarlander_disc_rezero_mz",
        "lunarlander_disc_sampled_muzero", "lunarlander_disc_sampled_unizero",
        "lunarlander_disc_stochastic_muzero", "lunarlander_disc_unizero")},
    **{name: f"box2d.bipedalwalker.config.{name}_config" for name in (
        "bipedalwalker_cont_sampled_efficientzero", "bipedalwalker_cont_sampled_muzero",
        "bipedalwalker_cont_sampled_unizero")},
    "mtcar_muzero": "classic_control.mountain_car.config.mtcar_muzero_config",
    "mujoco_sampled_efficientzero": "mujoco.config.mujoco_sampled_efficientzero_config",
    **{name: f"dmc2gym.config.{name}_config" for name in (
        "dmc2gym_pixels_sez", "dmc2gym_state_sez", "dmc2gym_state_smz", "dmc2gym_state_suz")},
}
OTHER = {
    **{name: f"classic_control.pendulum.config.{name}_config" for name in (
        "pendulum_cont_disc_efficientzero", "pendulum_cont_disc_gumbel_muzero",
        "pendulum_cont_disc_stochastic_muzero", "pendulum_cont_disc_unizero",
        "pendulum_disc_muzero", "pendulum_sampled_unizero_ln", "pendulum_sampled_unizero_lr1e3",
        "pendulum_sampled_unizero_v2", "pendulum_sampled_unizero_v2_cont", "pendulum_sez_uniform",
        "pendulum_smz_uniform")},
    **{name: f"classic_control.cartpole.config.{name}_config" for name in (
        "cartpole_muzero_cont", "cartpole_sampled_efficientzero", "cartpole_stochastic_muzero")},
    "stochastic_muzero_2048_v2": "game_2048.config.stochastic_muzero_2048_v2_config",
    **{name: f"memory.config.{name}_config" for name in (
        "memory100_unizero", "memory100_unizero_v2", "memory250_unizero")},
    **{name: f"breakout_grid.config.{name}_config" for name in (
        "breakout_grid_unizero_768", "breakout_grid_unizero_768_resume",
        "breakout_grid_unizero_768_v2", *(f"breakout_grid_unizero_v{i}" for i in range(2, 10)))},
}
# the zoo configs with env=dict(type="lunarlander"), on which JAX fails
JAX_FAILS = ("lunarlander_disc_sampled_muzero", "lunarlander_disc_sampled_unizero")
GYMNASIUM = [n for n in HOST if not n.startswith("dmc2gym") and n not in JAX_FAILS]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(name):
    return importlib.import_module(f"lightzero_tpu_torch.configs.{name}").main_config


def test_the_config_tables_count_as_the_roadmap_does():
    assert len(HOST) == 20 and len(OTHER) == 29 and len(GYMNASIUM) == 14


@pytest.mark.parametrize("name", sorted({**HOST, **OTHER}))
def test_config_equals_the_zoo_file(name):
    zoo = importlib.import_module(f"zoo.{({**HOST, **OTHER})[name]}").main_config
    assert port_config(name).to_dict() == JaxConfig(zoo).to_dict()


def shrunk(name, exp_dir):
    """4 simulations, batches of 8, 16-step episodes (125-step DMC episodes:
    a frame skip of 8 over its 1000 control steps), 2 learn steps a collect
    round, small widths, stop_value out of reach."""
    cfg = copy.deepcopy(port_config(name))
    cfg.exp_name = str(exp_dir)
    cfg.env.update(collector_env_num=2, evaluator_env_num=2, n_evaluator_episode=2,
                   stop_value=1e9)
    limit = dict(frame_skip=8) if cfg.env.get("env_id") == "dmc2gym" else dict(
        max_episode_steps=16)
    cfg.env.env_kwargs = dict(cfg.env.get("env_kwargs", {}), **limit)
    p = cfg.policy
    kind = p.get("type", "muzero")
    if "unizero" in kind:
        p.model.update(embed_dim=16, num_heads=2, max_tokens=12)
    else:
        p.model.update(latent_state_dim=16, proj_hid=32, proj_out=32, pred_hid=16, pred_out=32)
        if "efficientzero" in kind:
            p.model.lstm_hidden_size = 16
    if p.model.get("model_type") == "conv":
        p.model.num_channels = 4
    if "num_of_sampled_actions" in p:
        p.num_of_sampled_actions = min(p.num_of_sampled_actions, 3)
    if "reanalyze_batch_size" in p:
        p.reanalyze_batch_size = 8
    p.update(num_simulations=4, batch_size=8, update_per_collect=2, n_episode=2, eval_freq=1000)
    return cfg


def check_run(tmp_path, policy, state, stats):
    assert stats["train_iter"] == 2 == state.train_iter
    assert stats["env_steps"] > 0 and stats["eval_env_steps"] > 0
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    with open(tmp_path / "exp" / "log" / "train.jsonl") as f:
        losses = [json.loads(line)["learner/total_loss"] for line in f
                  if "learner/total_loss" in line]
    assert losses and np.all(np.isfinite(losses))
    assert (tmp_path / "exp" / "ckpt" / "ckpt_final.pt").exists()


@pytest.mark.parametrize("name", GYMNASIUM)
def test_gymnasium_config_trains_shrunk_through_the_port(tmp_path, name):
    cfg = shrunk(name, tmp_path / "exp")
    policy, state, stats = train_muzero(cfg, seed=0, max_train_iter=2, device="cpu")
    check_run(tmp_path, policy, state, stats)
    assert type(stats["buffer"]).__name__ == "GameBuffer"
    ep = stats["buffer"]._episodes[0]
    assert ep.obs.shape[1:] == (np.atleast_1d(cfg.policy.model.observation_shape)[0],)
    assert len(ep.actions) <= 16 and not ep.truncated  # the host collector's record


@pytest.mark.parametrize("name", JAX_FAILS)
def test_the_lunarlander_type_configs_fail_in_jax_and_are_refused(tmp_path, name):
    import gymnasium

    zoo = importlib.import_module(f"zoo.{HOST[name]}").main_config
    assert zoo.env.type == "lunarlander" and "env_id" not in zoo.env
    # where JAX's train_muzero builds its collect envs (train_muzero.py:160)
    with pytest.raises(gymnasium.error.NameNotFound):
        jax_make_host_vec_env(JaxConfig(zoo).env, 2, 0)
    with pytest.raises(ValueError, match="NameNotFound"):
        train_muzero(shrunk(name, tmp_path / "exp"), device="cpu")
