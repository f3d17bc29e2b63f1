"""The port's training entry on the CPU (lightzero_tpu_torch/entry/train_muzero.py),
mirroring tests/test_train_pipeline.py at a size that runs in seconds:
CartPole, 2 collect envs, latent 32, projector 64, support scale 10, 5
simulations, batch 16, the SSL loss on.

- a run of a few hundred env steps leaves total_config.json, log/train.jsonl
  and the checkpoints in its exp dir, with finite losses;
- a second run with auto_resume continues from the first's train_iter;
- a poisoned (NaN) loss stops the run and writes ckpt/ckpt_nan;
- checkpoints round-trip exactly, and the lenient load of a params export
  keeps the fresh optimizer;
- the entry refuses what is not ported and, with no GPU, a call without a
  device; it refuses, with a ValueError, observations its model cannot read
  (the zoo's plain MuZero 2048 configs, on which the JAX entry raises a
  ScopeParamShapeError, shown), and the Stochastic MuZero policy refuses a
  conv model, on which the JAX policy fails the same way (shown); both sampled policies refuse reanalyze, which the JAX policies
  cannot run (their forward_reanalyze raises an AttributeError, shown);
- each policy type it builds is the port of the JAX registry's policy of
  that name.
"""
import json
import os

import numpy as np
import pytest
import torch

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import train_muzero
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_checkpoint_lenient,
    save_checkpoint,
    save_params_export,
)

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


MODEL = dict(observation_shape=4, action_space_size=2, model_type="mlp", latent_state_dim=32,
             support_scale=10, self_supervised_learning_loss=True,
             proj_hid=64, proj_out=64, pred_hid=32, pred_out=64)


def tiny_cfg(exp_dir, **policy):
    return Config(dict(
        exp_name=str(exp_dir),
        env=dict(env_id="CartPole-v0", stop_value=10_000, collector_env_num=2,
                 evaluator_env_num=2, n_evaluator_episode=2),
        policy=dict(dict(model=MODEL, num_simulations=5, batch_size=16, update_per_collect=4,
                         n_episode=2, eval_freq=1000, ssl_loss_weight=2, learning_rate=0.003),
                    **policy),
    ))


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_muzero_runs_and_resumes(tmp_path):
    exp = tmp_path / "exp"
    cfg = tiny_cfg(exp, auto_resume=True, save_ckpt_freq=4)
    policy, state, stats = train_muzero(cfg, seed=0, max_env_step=200, device="cpu")
    # 2 chunks of 64 steps x 2 envs; 4 learn steps after each
    assert stats["env_steps"] == 256 and stats["train_iter"] == 8 and state.train_iter == 8
    assert stats["eval_env_steps"] > 0 and stats["buffer"].num_transitions > 16
    assert os.path.exists(exp / "total_config.json")
    with open(exp / "total_config.json") as f:
        assert json.load(f)["policy"]["batch_size"] == 16
    learner = [r for r in read_jsonl(exp / "log" / "train.jsonl") if "learner/total_loss" in r]
    assert len(learner) == 2 and all(np.isfinite(r["learner/total_loss"]) for r in learner)
    assert os.path.getsize(exp / "log" / "train.txt") > 0
    for name in ("ckpt_final.pt", "ckpt_best.pt", "params_best.pt", "iteration_8.pt"):
        assert os.path.exists(exp / "ckpt" / name), name
    with open(exp / "ckpt" / "resume_meta.json") as f:
        assert json.load(f) == dict(last_ckpt="iteration_8", train_iter=8, env_steps=256)
    # the rerun restores iteration 8 and its env steps, then trains on
    _, state2, stats2 = train_muzero(cfg, seed=0, max_env_step=300, device="cpu")
    assert stats2["env_steps"] == 384 and stats2["train_iter"] == 12 and state2.train_iter == 12
    assert "auto_resume: restored iteration_8" in (exp / "log" / "train.txt").read_text()


def test_nan_loss_raises_with_ckpt_nan(tmp_path, monkeypatch):
    original = MuZeroPolicy._loss_fn

    def poisoned(self, model, batch):
        loss, (logs, priority) = original(self, model, batch)
        logs["total_loss"] = logs["total_loss"] * float("nan")
        return loss * float("nan"), (logs, priority)

    monkeypatch.setattr(MuZeroPolicy, "_loss_fn", poisoned)
    exp = tmp_path / "exp_nan"
    with pytest.raises(RuntimeError, match="non-finite total_loss"):
        train_muzero(tiny_cfg(exp), seed=0, max_env_step=3000, device="cpu")
    assert os.path.exists(exp / "ckpt" / "ckpt_nan.pt")
    saved = load_checkpoint(str(exp / "ckpt" / "ckpt_nan"))
    assert saved["train_iter"] == 4


def _trained_state(seed=0):
    policy = MuZeroPolicy(dict(model=MODEL, num_simulations=2), device="cpu", seed=seed)
    state = policy.init_train_state()
    for p in policy.model.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    state.lr_scheduler.step()
    return policy, state._replace(train_iter=1)


def test_checkpoint_round_trip(tmp_path):
    _, state = _trained_state()
    path = save_checkpoint(state, str(tmp_path / "ckpt" / "iteration_1"))
    assert path.endswith("iteration_1.pt")
    _, fresh = _trained_state(seed=1)
    fresh = fresh._replace(train_iter=0)
    restored = load_checkpoint(str(tmp_path / "ckpt" / "iteration_1"), target=fresh)
    assert restored.train_iter == 1
    for a, b in zip(state.model.state_dict().values(), restored.model.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    for i in sa["state"]:
        assert all(torch.equal(sa["state"][i][k], sb["state"][i][k]) for k in sa["state"][i])
    assert restored.lr_scheduler.last_epoch == 1


def test_lenient_load_of_a_params_export_keeps_the_fresh_optimizer(tmp_path):
    _, state = _trained_state()
    save_params_export(state, str(tmp_path / "params_best"))
    policy = MuZeroPolicy(dict(model=MODEL, num_simulations=2), device="cpu", seed=5)
    fresh = policy.init_train_state()
    with pytest.raises(KeyError):
        load_checkpoint(str(tmp_path / "params_best"), target=fresh)
    restored = load_checkpoint_lenient(str(tmp_path / "params_best"), target=fresh)
    assert restored.train_iter == 0 and not restored.optimizer.state
    for a, b in zip(state.model.state_dict().values(), restored.model.state_dict().values()):
        assert torch.equal(a, b)
    # a model of another width does not fit: nothing to fall back to
    other = MuZeroPolicy(dict(model=dict(MODEL, latent_state_dim=16), num_simulations=2),
                         device="cpu").init_train_state()
    with pytest.raises(RuntimeError):
        load_checkpoint_lenient(str(tmp_path / "params_best"), target=other)


GOMOKU_MODEL = dict(observation_shape=(6, 6, 3), action_space_size=36, model_type="conv",
                    num_channels=4, num_res_blocks=1, downsample=False, support_scale=10,
                    proj_hid=32, proj_out=32, pred_hid=16, pred_out=32)


# the gumbel_muzero-on-a-board and gomoku cases were refused until slice
# 17's second half was ported, the harmony case until slice 20, and UniZero
# with the LPIPS perceptual loss and the loss-landscape analysis until slice
# 21; each now builds its policy and takes one collect. The multitask types
# train through their own entries since slice 19; train_muzero refuses them
# with the failure they meet in the JAX package's train_muzero
@pytest.mark.parametrize("override,error,match", [
    (dict(policy=dict(type="unizero", latent_recon_loss_weight=0.1, perceptual_loss_weight=1.0)),
     None, None),
    (dict(policy=dict(type="muzero_multitask")), ValueError, "AttributeError"),
    (dict(policy=dict(type="gumbel_muzero", env_type="board_games")), None, None),
    (dict(env=dict(env_id="gomoku", env_kwargs=dict(board_size=6, n_in_row=4)),
          policy=dict(env_type="board_games", model=GOMOKU_MODEL)), None, None),
    (dict(policy=dict(type="sampled_muzero", env_type="board_games")), ValueError,
     "float arrays"),
    (dict(policy=dict(analysis_loss_landscape=True)), None, None),
    (dict(policy=dict(model=dict(MODEL, harmony_balance=True))), None, None),
], ids=["unizero", "multitask", "gumbel_board", "gomoku", "sampled_board", "landscape",
        "harmony"])
def test_train_muzero_refuses_what_is_not_ported(tmp_path, override, error, match):
    cfg = tiny_cfg(tmp_path / "exp")
    for key, value in override.items():
        cfg[key] = dict(cfg[key], **value)
    if error is not None:
        with pytest.raises(error, match=match):
            train_muzero(cfg, device="cpu")
        return
    policy, state, stats = train_muzero(cfg, max_env_step=1, device="cpu")
    assert stats["env_steps"] > 0 and stats["buffer"].num_transitions > 0
    if cfg.policy.get("env_type") == "board_games":
        assert policy.players == 2
    if cfg.policy.get("perceptual_loss_weight"):
        assert policy.lpips is not None  # built, and idle on vector observations
    if cfg.policy.get("analysis_loss_landscape"):
        # the surface after training, as JAX writes it (slice 21)
        surface = np.load(os.path.join(cfg.exp_name, "loss_landscape", "loss_surface_1d.npz"))
        assert surface["loss"].shape == (11,) and np.isfinite(surface["loss"]).all()
    if cfg.policy.model.get("harmony_balance"):
        # HarmonyDream runs since slice 20: its scalars start at 0 and train
        assert state.train_iter > 0
        assert all(float(getattr(policy.model, k).detach()) != 0.0
                   for k in ("harmony_policy", "harmony_value", "harmony_reward"))


SAMPLED = ["sampled_muzero", "sampled_efficientzero"]


@pytest.mark.parametrize("policy_type", SAMPLED)
def test_sampled_policies_refuse_reanalyze(tmp_path, policy_type):
    cfg = tiny_cfg(tmp_path / "exp", type=policy_type, reanalyze_ratio=0.25,
                   model=dict(observation_shape=3, action_space_size=1, latent_state_dim=8,
                              support_scale=5))
    cfg.env = dict(cfg.env, env_id="Pendulum-v1")
    with pytest.raises(NotImplementedError, match="reanalyze"):
        train_muzero(cfg, device="cpu")


@pytest.mark.parametrize("policy_type", SAMPLED)
def test_the_jax_sampled_policys_reanalyze_fails_on_its_models_outputs(policy_type):
    """The JAX policies do not override _forward_reanalyze
    (lightzero_tpu/policy/muzero.py:493), which reads ``policy_logits`` off
    the dict their models return (ROADMAP queue 3)."""
    import importlib

    import jax
    import jax.numpy as jnp

    from lightzero_tpu.config.core import deep_merge as jax_deep_merge
    from lightzero_tpu.utils.registry import POLICY_REGISTRY

    importlib.import_module(f"lightzero_tpu.policy.{policy_type}")  # registers it
    cls = POLICY_REGISTRY.get(policy_type)
    jax_policy = cls(jax_deep_merge(cls.default_config(), dict(
        num_of_sampled_actions=3, num_simulations=2,
        model=dict(observation_shape=3, action_space_size=1, latent_state_dim=8,
                   lstm_hidden_size=8, support_scale=5))))
    params = jax_policy.model.init_params(jax.random.PRNGKey(0))
    with pytest.raises(AttributeError, match="policy_logits"):
        jax_policy.forward_reanalyze(params, jax.random.PRNGKey(1), jnp.zeros((2, 3)),
                                     jnp.ones((2, 1), bool))


@pytest.mark.parametrize("policy_type",
                         ["muzero", "efficientzero", "gumbel_muzero", "stochastic_muzero"] + SAMPLED
                         + ["muzero_context", "muzero_rnn_full_obs", "unizero", "sampled_unizero"])
def test_train_muzero_builds_the_port_of_the_jax_policy(policy_type):
    import importlib

    from lightzero_tpu.utils.registry import POLICY_REGISTRY
    from lightzero_tpu_torch.entry.train_muzero import POLICIES

    assert sorted(POLICIES) == ["efficientzero", "gumbel_muzero", "muzero", "muzero_context",
                                "muzero_rnn_full_obs", "sampled_efficientzero",
                                "sampled_muzero", "sampled_unizero", "stochastic_muzero",
                                "unizero"]
    importlib.import_module(f"lightzero_tpu.policy.{policy_type}")  # registers it
    policy_cls = POLICIES[policy_type]
    assert policy_cls.__name__ == POLICY_REGISTRY.get(policy_type).__name__
    assert policy_cls.default_config().type == policy_type


def test_train_muzero_without_device_raises_with_no_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_muzero(tiny_cfg(tmp_path / "exp"))
    assert not os.path.exists(tmp_path / "exp")


def test_entry_utils():
    import threading

    from lightzero_tpu_torch.entry.utils import (
        calculate_update_per_collect,
        random_collect,
        safe_eval,
    )

    assert calculate_update_per_collect(Config(dict(update_per_collect=7)), 1000) == 7
    assert calculate_update_per_collect(Config(dict(replay_ratio=0.25)), 1000) == 250
    assert calculate_update_per_collect(Config(dict(replay_ratio=0.25)), 2) == 1

    class Collector:
        def collect(self, temperature, epsilon, num_episodes):
            assert (temperature, epsilon) == (1.0, 1.0)  # every action random
            return ["ep"] * num_episodes, [None] * num_episodes, dict(episodes=num_episodes)

    class Buffer:
        def push_episodes(self, episodes, priorities):
            self.pushed = episodes

    buf = Buffer()
    assert random_collect(Collector(), buf, num_episodes=3) == dict(episodes=3)
    assert buf.pushed == ["ep"] * 3

    release = threading.Event()

    class Evaluator:
        def __init__(self, mode):
            self.mode = mode

        def eval(self, n_episodes=None):
            if self.mode == "hang":
                release.wait(10)
            if self.mode == "fail":
                raise ValueError("eval failed")
            return dict(mean_return=1.0, n=n_episodes)

    assert safe_eval(Evaluator("ok"), n_episodes=2) == dict(mean_return=1.0, n=2)
    assert safe_eval(Evaluator("hang"), timeout_s=0.05) is None
    release.set()
    with pytest.raises(ValueError, match="eval failed"):
        safe_eval(Evaluator("fail"))


@pytest.mark.parametrize("config", ["muzero_2048_config", "muzero_2048_v2_config"])
def test_plain_muzero_2048_configs_fail_in_jax_and_are_refused_by_the_port(tmp_path, config):
    """ROADMAP queue 3: the zoo's plain MuZero 2048 configs set an MLP over
    256 inputs, and the env gives (4, 4, 16) planes, which MuZero does not
    flatten. The JAX entry fails at its first eval with flax's
    ScopeParamShapeError; the port's refuses the config up front."""
    import copy
    import importlib

    import flax

    from lightzero_tpu.entry import train_muzero as jax_train_muzero

    main_config = importlib.import_module(f"zoo.game_2048.config.{config}").main_config
    jax_cfg = copy.deepcopy(main_config)
    jax_cfg.exp_name = str(tmp_path / "jax")
    with pytest.raises(flax.errors.ScopeParamShapeError, match="Dense_0"):
        jax_train_muzero(jax_cfg, seed=0, max_env_step=10)
    cfg = Config(main_config.to_dict())
    cfg.exp_name = str(tmp_path / "port")
    with pytest.raises(ValueError, match=r"shape \(256,\).*\(4, 4, 16\)"):
        train_muzero(cfg, device="cpu", max_env_step=10)


def test_the_jax_stochastic_policy_fails_on_its_conv_model():
    """ROADMAP queue 3: the JAX Stochastic MuZero policy flattens every
    observation (policy/stochastic_muzero.py:76-81) before its conv model,
    which fails with a ScopeParamShapeError; the port's policy refuses a
    conv model with a ValueError."""
    import flax
    import jax
    import jax.numpy as jnp

    from lightzero_tpu.policy.stochastic_muzero import StochasticMuZeroPolicy as JaxPolicy
    from lightzero_tpu_torch.policy import StochasticMuZeroPolicy

    model = dict(observation_shape=(6, 6, 4), action_space_size=3, model_type="conv",
                 num_channels=8, chance_space_size=4, downsample=False)
    cfg = JaxPolicy.default_config()
    cfg.model.update(model)
    cfg.num_simulations = 2
    jax_policy = JaxPolicy(cfg)
    params = jax_policy.init_train_state(jax.random.PRNGKey(0)).params
    with pytest.raises(flax.errors.ScopeParamShapeError, match="_repr/Conv_0"):
        jax_policy.forward_eval(params, jax.random.PRNGKey(1), jnp.zeros((2, 6, 6, 4)),
                                jnp.ones((2, 3), bool))
    with pytest.raises(ValueError, match="flattens observations"):
        StochasticMuZeroPolicy(dict(model=model, num_simulations=2), device="cpu")
