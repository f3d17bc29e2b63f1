"""The offline checkpoint sweep (lightzero_tpu_torch/entry/eval_offline.py
against lightzero_tpu/entry/eval_offline.py) and the gym-env entry aliases.

- A shrunk CartPole run through the port's train_muzero writes iteration_*,
  ckpt_best and ckpt_final checkpoints; eval_offline sweeps exactly those,
  in name order, and each mean return equals the Evaluator's on that
  checkpoint loaded by hand, with the same seed; the best is their argmax.
  train_unizero_multitask_segment_eval is eval_offline, as in JAX.
- On a host env the JAX eval_offline and eval_muzero (hence
  eval_muzero_with_gym_env) hand create_env's None to their Evaluator and
  fail with AttributeError; the port refuses them with a ValueError that
  quotes it. train_muzero_with_gym_env is train_muzero, as in JAX.
"""
import copy
import importlib

import numpy as np
import pytest
import torch

import lightzero_tpu.entry as jax_entry
from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu_torch import entry
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import eval_offline, train_muzero
from lightzero_tpu_torch.entry.eval_offline import checkpoints
from lightzero_tpu_torch.envs import CartPoleEnv
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.utils.checkpoint import load_checkpoint
from lightzero_tpu_torch.workers import Evaluator

pytestmark = pytest.mark.unittest

MODEL = dict(observation_shape=4, action_space_size=2, latent_state_dim=16, support_scale=10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cfg(exp_dir):
    return Config(dict(
        exp_name=str(exp_dir),
        env=dict(env_id="CartPole-v0", stop_value=10_000, collector_env_num=2,
                 evaluator_env_num=2, n_evaluator_episode=2, max_episode_steps=20),
        policy=dict(model=MODEL, num_simulations=3, batch_size=8, update_per_collect=2,
                    n_episode=2, eval_freq=2, save_ckpt_freq=2),
    ))


def test_eval_offline_sweeps_the_runs_checkpoints(tmp_path):
    cfg = tiny_cfg(tmp_path / "exp")
    train_muzero(cfg, seed=0, max_train_iter=4, device="cpu")
    ckpt_dir = tmp_path / "exp" / "ckpt"
    names = checkpoints(str(ckpt_dir))
    assert names == ["ckpt_best", "ckpt_final", "iteration_2", "iteration_4"]
    assert (ckpt_dir / "params_best.pt").exists()  # a params export: not swept
    res = eval_offline(copy.deepcopy(cfg), seed=3, n_episodes=2, device="cpu")
    assert list(res["results"]) == names
    assert res["best_return"] == max(res["results"].values())
    assert res["results"][res["best_ckpt"]] == res["best_return"]
    policy = MuZeroPolicy(dict(model=MODEL, num_simulations=3), device="cpu", seed=3)
    state = policy.init_train_state()
    evaluator = Evaluator(CartPoleEnv(max_episode_steps=20), policy, 2, seed=3, device="cpu")
    for name in names:
        load_checkpoint(str(ckpt_dir / name), target=state)
        assert evaluator.eval(n_episodes=2)["mean_return"] == res["results"][name], name
    assert entry.train_unizero_multitask_segment_eval is eval_offline
    assert jax_entry.train_unizero_multitask_segment_eval is jax_entry.eval_offline


def host_cfg(exp_dir):
    return dict(exp_name=str(exp_dir),
                env=dict(env_id="MountainCar-v0", collector_env_num=2, evaluator_env_num=2),
                policy=dict(model=dict(observation_shape=2, action_space_size=3,
                                       latent_state_dim=8, support_scale=5),
                            num_simulations=2))


def test_host_configs_fail_in_the_jax_evals_and_are_refused(tmp_path, monkeypatch):
    cfg = host_cfg(tmp_path / "exp")
    (tmp_path / "exp" / "ckpt").mkdir(parents=True)
    torch.save({}, tmp_path / "exp" / "ckpt" / "iteration_1.pt")
    (tmp_path / "exp" / "ckpt" / "iteration_1").mkdir()  # what the JAX sweep lists
    match = "'NoneType' object has no attribute 'reset'"
    with pytest.raises(ValueError, match=match):
        eval_offline(Config(cfg), device="cpu")
    with pytest.raises(ValueError, match=match):
        entry.eval_muzero_with_gym_env(Config(cfg), device="cpu")
    jax_eval_offline = importlib.import_module("lightzero_tpu.entry.eval_offline")
    # the sweep's restore needs an orbax checkpoint; the env fails before it matters
    monkeypatch.setattr(jax_eval_offline, "load_checkpoint", lambda path, target: target)
    with pytest.raises(AttributeError, match=match):
        jax_eval_offline.eval_offline(JaxConfig(cfg))
    with pytest.raises(AttributeError, match=match):
        jax_entry.eval_muzero_with_gym_env(JaxConfig(cfg), n_episodes=1)


def test_train_muzero_with_gym_env_runs_a_host_config(tmp_path):
    assert entry.train_muzero_with_gym_env is train_muzero
    assert jax_entry.train_muzero_with_gym_env is jax_entry.train_muzero
    cfg = Config(host_cfg(tmp_path / "exp"))
    cfg.env = Config(dict(cfg.env, stop_value=1e9, env_kwargs=dict(max_episode_steps=16)))
    cfg.policy = Config(dict(cfg.policy, batch_size=8, update_per_collect=2, n_episode=2,
                             eval_freq=1000))
    policy, state, stats = entry.train_muzero_with_gym_env(cfg, max_train_iter=2, device="cpu")
    assert stats["train_iter"] == 2 and stats["env_steps"] == 32 and stats["eval_env_steps"] == 16
    assert np.isfinite(stats["best_return"])
