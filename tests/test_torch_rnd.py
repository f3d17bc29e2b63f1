"""Port vs JAX: the RND reward model and its entry
(lightzero_tpu_torch/reward_model/rnd.py and
entry/train_muzero_with_reward_model.py against lightzero_tpu/reward_model/rnd.py
and lightzero_tpu/entry/train_muzero_with_reward_model.py).

- The JAX model's target and predictor nets carried into the port with
  params_import (and back, bit-equal): on numpy-seeded observations the
  prediction errors agree to 1e-6 relative; four train steps (Adam at 3e-4)
  give the same losses to 1e-6 relative and predictor params to 1e-6
  absolute; the estimate after each, on JAX's predictor loaded again,
  gives the same running count, mean and M2 and shaped rewards to 1e-6
  relative, and the same intrinsic rewards, (error - mean) / std, to 1e-6
  in the errors' units (times std: the errors themselves differ by a
  float32 step, 1.2e-7 near 1, which the division by a std of about 0.2
  would make 6e-7), with the weight's decay over 10 steps visible.
- The entry on the zoo's memory_muzero_rnd config, shrunk: one RND train
  step and one estimate per collected episode, the buffer holding the
  shaped rewards, the final checkpoint. Its intrinsic weight is the policy
  config's default 0.01, not the reward_model's 0.003, in both packages (the
  JAX entry's weight is read from the same key); JAX's train_muzero never
  reads cfg.reward_model, and the port's refuses it. On a host env the JAX
  entry fails, and the port refuses it.
"""
import copy
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.reward_model import RNDRewardModel as JaxRND
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import train_muzero, train_muzero_with_reward_model
from lightzero_tpu_torch.reward_model import RNDRewardModel
from lightzero_tpu_torch.utils.params_import import rnd_flax_to_state_dict, rnd_state_dict_to_flax

pytestmark = pytest.mark.unittest

# the modules (the JAX package's entry/__init__ binds the functions' names)
jax_train_muzero_module = importlib.import_module("lightzero_tpu.entry.train_muzero")
jax_rnd_entry = importlib.import_module("lightzero_tpu.entry.train_muzero_with_reward_model")

RTOL = 1e-6
OBS_DIM = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def models(decay_steps=100_000):
    jax_model = JaxRND(OBS_DIM, intrinsic_reward_weight=0.5, weight_decay_steps=decay_steps)
    jax_state = jax_model.init_state(jax.random.PRNGKey(3))
    port = RNDRewardModel(OBS_DIM, intrinsic_reward_weight=0.5, weight_decay_steps=decay_steps,
                          device="cpu")
    port.load_state_dict(rnd_flax_to_state_dict(as_np(jax_state.target_params),
                                                as_np(jax_state.predictor_params)))
    return jax_model, jax_state, port, port.init_state()


def observations(seed, n=24):
    return np.random.default_rng(seed).normal(0, 2, (n, OBS_DIM)).astype(np.float32)


def test_params_import_carries_both_nets_both_ways():
    _, jax_state, port, _ = models()
    target, predictor = rnd_state_dict_to_flax(port.state_dict())
    for got, exp in ((target, jax_state.target_params), (predictor, jax_state.predictor_params)):
        got, exp = flat(got), flat(exp)
        assert set(got) == set(exp)
        for k in exp:
            np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
    assert not any(p.requires_grad for p in port.target.parameters())


def test_error_matches_jax():
    jax_model, jax_state, port, _ = models()
    obs = observations(0)
    exp = np.asarray(jax_model._error(jax_state, jnp.asarray(obs)))
    got = port.error(obs).detach().numpy()
    np.testing.assert_allclose(got, exp, rtol=RTOL)


def deviation(state):
    return float(np.sqrt(max(float(state.m2) / float(state.count), 1e-8)))


def test_train_steps_and_estimates_match_jax():
    jax_model, jax_state, port, state = models(decay_steps=10)
    for step in range(4):
        obs = observations(10 + step, n=12 + 3 * step)
        jax_state, jax_loss = jax_model.train(jax_state, obs)
        state, loss = port.train_step(state, obs)
        np.testing.assert_allclose(loss, jax_loss, rtol=RTOL)
        assert state.train_iter == int(jax_state.train_iter) == step + 1
        got = flat(rnd_state_dict_to_flax(port.state_dict())[1])
        exp = flat(jax_state.predictor_params)
        for k in exp:
            np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=1e-6, err_msg=f"{step} {k}")
        # the estimate on the same weights: an error of 1e-7 in the errors
        # (about 1) would be 1e-6 in the intrinsic rewards, which are their
        # difference from the mean over the deviation
        port.load_state_dict(rnd_flax_to_state_dict(as_np(jax_state.target_params),
                                                    as_np(jax_state.predictor_params)))
        rewards = np.random.default_rng(step).uniform(-1, 1, len(obs)).astype(np.float32)
        jax_state, jax_new, jax_intr = jax_model.estimate(jax_state, obs, rewards)
        state, new, intr = port.estimate(state, obs, rewards)
        for name in ("count", "mean", "m2"):
            np.testing.assert_allclose(float(getattr(state, name)),
                                       float(getattr(jax_state, name)), rtol=RTOL, err_msg=name)
        # an intrinsic reward is (error - mean) / std: held in the errors'
        # units (x std), where a float32 step of an error near 1 (1.2e-7,
        # by which the two packages' matmuls differ) stays below 1e-6
        np.testing.assert_allclose(intr.numpy() * deviation(state),
                                   np.asarray(jax_intr) * deviation(jax_state), rtol=0, atol=RTOL)
        np.testing.assert_allclose(new.numpy(), np.asarray(jax_new), rtol=RTOL, atol=RTOL)
        # the weight decays linearly over 10 train steps: 0.5 x (1 - step / 10)
        np.testing.assert_allclose((new - torch.from_numpy(rewards)).numpy(),
                                   0.5 * (1 - (step + 1) / 10) * intr.numpy(), rtol=1e-5,
                                   atol=1e-7)


def rnd_config(exp_dir):
    from lightzero_tpu_torch.configs.memory_muzero_rnd import main_config

    cfg = copy.deepcopy(main_config)
    cfg.exp_name = str(exp_dir)
    cfg.env.update(collector_env_num=2, evaluator_env_num=2, n_evaluator_episode=2,
                   stop_value=10.0, env_kwargs=dict(num_cues=4, memory_length=2))
    cfg.policy.model.update(latent_state_dim=16, proj_hid=32, proj_out=32, pred_hid=16,
                            pred_out=32)
    cfg.policy.update(num_simulations=4, batch_size=8, update_per_collect=2, n_episode=2,
                      eval_freq=1000, num_unroll_steps=4, td_steps=4)
    return cfg


def test_config_equals_the_zoo_file():
    from lightzero_tpu_torch.configs.memory_muzero_rnd import main_config
    from zoo.memory.config.memory_muzero_rnd_config import main_config as zoo

    assert main_config.to_dict() == JaxConfig(zoo).to_dict()


def test_entry_shapes_each_episode_and_trains(tmp_path, monkeypatch):
    calls = []
    train_step, estimate = RNDRewardModel.train_step, RNDRewardModel.estimate

    def spy_train(self, state, obs):
        calls.append(("train", obs.shape))
        return train_step(self, state, obs)

    def spy_estimate(self, state, obs, rewards):
        calls.append(("estimate", obs.shape))
        state, new, intr = estimate(self, state, obs, rewards)
        shaped.append((np.asarray(rewards), new.numpy(), intr.numpy(), self.weight,
                       state.train_iter))
        return state, new, intr

    shaped = []
    monkeypatch.setattr(RNDRewardModel, "train_step", spy_train)
    monkeypatch.setattr(RNDRewardModel, "estimate", spy_estimate)
    policy, state, stats = train_muzero_with_reward_model(rnd_config(tmp_path / "exp"), seed=0,
                                                          max_train_iter=2, device="cpu")
    assert stats["train_iter"] == 2 == state.train_iter and stats["eval_env_steps"] > 0
    episodes = stats["buffer"]._episodes
    n = len(episodes)
    assert n >= 2 and stats["rnd_state"].train_iter == n
    assert [c[0] for c in calls] == ["train", "estimate"] * n
    assert all(shape == (len(ep.actions), 8) for (_, shape), ep
               in zip(calls[1::2], episodes))
    for i, (ep, (raw, new, intr, weight, it)) in enumerate(zip(episodes, shaped)):
        assert weight == 0.01  # cfg.policy's default, not the reward_model's 0.003
        assert it == i + 1  # each estimate follows its episode's train step
        np.testing.assert_array_equal(ep.rewards, new)
        np.testing.assert_allclose(new - raw, 0.01 * (1 - it / 100_000) * intr, rtol=1e-4,
                                   atol=1e-9)
        assert np.any(new != raw)
    assert (tmp_path / "exp" / "ckpt" / "ckpt_final.pt").exists()
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_the_jax_entry_reads_the_weight_from_the_policy_config(monkeypatch, tmp_path):
    """The JAX entry builds its model with cfg.policy's weight (0.01 by
    default) and never reads cfg.reward_model (ROADMAP queue 3)."""
    from zoo.memory.config.memory_muzero_rnd_config import main_config as zoo

    seen = {}

    class Built(Exception):
        pass

    class Recorder:
        def __init__(self, obs_dim, **kwargs):
            seen.update(kwargs, obs_dim=obs_dim)
            raise Built  # stop the JAX entry before any compile

    monkeypatch.setattr(jax_rnd_entry, "RNDRewardModel", Recorder)
    cfg = JaxConfig(zoo.to_dict())
    cfg.exp_name = str(tmp_path / "exp")
    cfg.policy.model.latent_state_dim = 8
    with pytest.raises(Built):
        jax_rnd_entry.train_muzero_with_reward_model(cfg)
    assert seen == dict(obs_dim=8, intrinsic_reward_weight=0.01)
    assert cfg.reward_model.intrinsic_reward_weight == 0.003


def test_train_muzero_refuses_the_reward_model_that_jax_ignores(tmp_path):
    assert "reward_model" not in inspect.getsource(jax_train_muzero_module.train_muzero)
    with pytest.raises(ValueError, match="train_muzero_with_reward_model"):
        train_muzero(rnd_config(tmp_path / "exp"), device="cpu")


def test_a_host_env_fails_in_the_jax_entry_and_is_refused(tmp_path):
    cfg = rnd_config(tmp_path / "exp")
    cfg.env = Config(dict(env_id="MountainCar-v0", collector_env_num=2, evaluator_env_num=2))
    cfg.policy.model.update(observation_shape=2, action_space_size=3)
    with pytest.raises(ValueError, match="'NoneType' object has no attribute 'reset'"):
        train_muzero_with_reward_model(cfg, device="cpu")
    jax_cfg = JaxConfig(cfg.to_dict())
    jax_cfg.exp_name = str(tmp_path / "jax")
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'reset'"):
        jax_rnd_entry.train_muzero_with_reward_model(jax_cfg)
