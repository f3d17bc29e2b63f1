"""The multitask entries of the port on the CPU (lightzero_tpu_torch/entry/
train_muzero_multitask.py and train_multitask_balance.py), shrunk (embed 16,
3-4 simulations, batches of 4-8 rows a task, short episodes):

- the four configs equal their zoo files key for key, and the ScaleZero v3
  config merged with its policy's defaults is the policy of the committed
  run ``data_mt/pendulum_suite_scalezero_v3_seed0/total_config.json``;
- ``train_muzero_multitask`` trains each multitask type (each task's
  workers on its task view) and a single-task type (the task weights in the
  importance weights): finite params, every task collected and evaluated;
- ``train_multitask_balance`` on the ScaleZero v3 config with a forced
  stage switch at the first eval (one task always solved, the others never;
  patience 1): every learn step at stage 1 leaves the transformer backbone
  bit-equal to its initial weights while adapter 1, the encoder and the
  heads move; ``ckpt_best``, ``params_best``, the periodic checkpoint and
  its resume sidecar are written, and ``auto_resume`` restores the stage
  and the counters; with every task solved the run stops, after the
  round's learn steps or, when no buffer holds a batch yet, at once;
  the CartPole + Pendulum balance config (plain ``unizero``, observations
  padded) runs;
- ``train_muzero`` refuses the multitask types with a ValueError, where the
  JAX package's ``train_muzero`` raises AttributeError at the first learn
  step; the entry aliases.
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
from lightzero_tpu_torch.config import deep_merge
from lightzero_tpu_torch.configs.cartpole_muzero import main_config as cartpole_muzero
from lightzero_tpu_torch.configs.cartpole_unizero import main_config as cartpole_unizero
from lightzero_tpu_torch.policy import (
    MuZeroMTPolicy,
    MuZeroPolicy,
    SampledUniZeroMTPolicy,
    UniZeroMTPolicy,
)

pytestmark = pytest.mark.unittest

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ("cartpole_pendulum_balance", "pendulum_suite_scalezero", "pendulum_suite_scalezero_v2",
           "pendulum_suite_scalezero_v3")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_configs(name):
    return importlib.import_module(f"lightzero_tpu_torch.configs.{name}").task_configs


@pytest.mark.parametrize("name", CONFIGS)
def test_config_is_the_zoo_config(name):
    zoo = importlib.import_module(f"zoo.multitask.config.{name}_config").task_configs
    assert [c.to_dict() for c in port_configs(name)] == [JaxConfig(c).to_dict() for c in zoo]


def test_scalezero_v3_config_is_the_committed_runs_policy():
    committed = json.loads(
        (REPO / "data_mt/pendulum_suite_scalezero_v3_seed0/total_config.json").read_text())
    merged = deep_merge(SampledUniZeroMTPolicy.default_config(),
                        port_configs("pendulum_suite_scalezero_v3")[0].policy)
    assert json.loads(json.dumps(merged.to_dict())) == committed["policy"]


def shrunk_suite(exp_dir, episode_steps=8, **policy):
    """The ScaleZero v3 tasks at embed 16, 3 simulations, K=4, unroll 3,
    4 rows a task."""
    cfgs = []
    for c in port_configs("pendulum_suite_scalezero_v3"):
        c = copy.deepcopy(c)
        c.exp_name = str(exp_dir)
        c.env.update(collector_env_num=2, evaluator_env_num=2, max_episode_steps=episode_steps)
        c.policy.model.update(embed_dim=16, num_heads=2)
        c.policy.update(dict(num_simulations=3, num_of_sampled_actions=4, num_unroll_steps=3,
                             batch_size=12, update_per_collect=2, eval_freq=1000,
                             save_ckpt_freq=2), **policy)
        cfgs.append(c)
    return cfgs


def shrunk_cartpole(exp_dir, policy_type, tasks=2):
    cfgs = []
    for _ in range(tasks):
        c = copy.deepcopy(cartpole_muzero)
        c.exp_name = str(exp_dir)
        c.env.update(collector_env_num=2, evaluator_env_num=2, max_episode_steps=16)
        c.policy.type = policy_type
        c.policy.model.latent_state_dim = 16
        c.policy.update(num_simulations=3, batch_size=16, update_per_collect=2, n_episode=2,
                        eval_freq=1000)
        cfgs.append(c)
    return cfgs


@pytest.mark.parametrize("policy_type", ["muzero_multitask", "muzero", "unizero_multitask",
                                         "sampled_unizero_multitask"])
def test_train_muzero_multitask_trains_each_type_shrunk(tmp_path, policy_type):
    if policy_type == "sampled_unizero_multitask":
        cfgs, cls = shrunk_suite(tmp_path / "exp", grad_correction="cagrad"), SampledUniZeroMTPolicy
    elif policy_type == "unizero_multitask":
        cfgs, cls = [], UniZeroMTPolicy
        for _ in range(3):
            c = copy.deepcopy(cartpole_unizero)
            c.exp_name = str(tmp_path / "exp")
            c.env.update(collector_env_num=2, evaluator_env_num=2, max_episode_steps=16)
            c.policy.type = policy_type
            c.policy.model.update(embed_dim=16, num_heads=2, max_tokens=12)
            c.policy.update(num_simulations=3, batch_size=12, update_per_collect=2, n_episode=2,
                            eval_freq=1000, reanalyze_ratio=0.5)
            cfgs.append(c)
    else:
        cfgs = shrunk_cartpole(tmp_path / "exp", policy_type)
        cls = MuZeroMTPolicy if policy_type == "muzero_multitask" else MuZeroPolicy
    policy, state, stats = entry.train_muzero_multitask(cfgs, seed=0, max_train_iter=2,
                                                        device="cpu")
    assert type(policy) is cls
    assert stats["train_iter"] == 2 == state.train_iter
    assert sorted(stats["task_env_steps"]) == list(range(len(cfgs)))
    assert all(stats["task_env_steps"][t] > 0 and stats["eval_env_steps"][t] > 0
               for t in range(len(cfgs)))
    if cls is not MuZeroPolicy:
        assert policy.task_num == len(cfgs)
        assert [b.policy._collect_task_id for b in stats["buffers"].values()] == [0, 1, 2][
            :len(cfgs)]
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert (tmp_path / "exp" / "ckpt" / "ckpt_final.pt").exists()
    logs = (tmp_path / "exp" / "log" / "train.jsonl").read_text().splitlines()
    losses = [json.loads(line)["learner/total_loss"] for line in logs
              if "learner/total_loss" in line]
    assert losses and all(np.isfinite(losses))


def backbone(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.startswith("transformer.") and "lora_" not in n and "_scale" not in n}


def test_balance_switches_stage_and_freezes_the_backbone(tmp_path):
    cfgs = shrunk_suite(tmp_path / "exp", solved_patience=1, stage_solved_frac=0.3)
    cfgs[0].env.solved_threshold = -1e9  # solved at the first eval
    for c in cfgs[1:]:
        c.env.solved_threshold = 1.0  # out of reach: a return is at most 0
    policy, state, stats = entry.train_multitask_balance(cfgs, seed=0, max_train_iter=4,
                                                         device="cpu")
    assert stats["stage"] == 1 and stats["solved"] == {0: True, 1: False, 2: False}
    assert stats["train_iter"] == 4
    # the switch came at the first eval, before any learn step
    init = SampledUniZeroMTPolicy(policy.cfg, device="cpu", seed=0).model
    start, end = backbone(init), backbone(state.model)
    assert "transformer.task_embed.weight" in end and any(n.endswith("base.weight") for n in end)
    assert all(torch.equal(end[n], v) for n, v in start.items())
    moved = {n for n, p in state.model.named_parameters()
             if not torch.equal(p, dict(init.named_parameters())[n])}
    assert any("lora_A_1" in n for n in moved) and any(n.startswith("encoder.") for n in moved)
    assert any(n.startswith("value_head.") for n in moved)
    assert {p for grp in state.optimizer.param_groups for p in grp["params"]}.isdisjoint(
        dict(state.model.named_parameters())[n] for n in end)
    ckpt = tmp_path / "exp" / "ckpt"
    for name in ("ckpt_best.pt", "params_best.pt", "iteration_2.pt", "iteration_4.pt",
                 "ckpt_final.pt"):
        assert (ckpt / name).exists(), name
    meta = json.loads((ckpt / "resume_meta.json").read_text())
    assert meta["stage"] == 1 and meta["train_iter"] == 4 and meta["last_ckpt"] == "iteration_4"
    # auto_resume: the stage, the counters and the params come back
    for c in cfgs:
        c.policy.auto_resume = True
    policy2, state2, stats2 = entry.train_multitask_balance(cfgs, seed=0, max_train_iter=6,
                                                            device="cpu")
    assert stats2["train_iter"] == 6 and stats2["stage"] == 1
    assert policy2.model.tcfg.curriculum_stage == 1
    assert stats2["env_steps"] > stats["env_steps"]
    assert all(torch.equal(v, backbone(state2.model)[n]) for n, v in start.items())
    log = (tmp_path / "exp" / "log" / "train.txt").read_text()
    assert "auto_resume: restored iteration_4 (iter=4" in log and "stage=1)" in log


@pytest.mark.parametrize("patience,iters", [(2, 4), (1, 0)], ids=["after_training", "at_once"])
def test_balance_stops_when_every_task_is_solved(tmp_path, patience, iters):
    """Solved at the second eval (iter 2), which advances the stage: the
    round's learn steps, then the stop, as in JAX. Solved at the first,
    before any buffer holds a batch: the stop at once, where the JAX entry
    loops forever."""
    cfgs = shrunk_suite(tmp_path / "exp", solved_patience=patience, eval_freq=2)
    for c in cfgs:
        c.env.solved_threshold = -1e9
    _, _, stats = entry.train_multitask_balance(cfgs, seed=0, max_train_iter=100, device="cpu")
    assert all(stats["solved"].values()) and stats["train_iter"] == iters
    assert "all tasks solved" in (tmp_path / "exp" / "log" / "train.txt").read_text()
    if iters:
        # the stage advanced at the second eval, after a collect round: the
        # workers carry on, so the env-step count keeps that round (the JAX
        # entry rebuilds them there and counts from 0 again)
        assert stats["stage"] == 1
        assert stats["env_steps"] == sum(stats["task_env_steps"].values()) > 0


def test_balance_runs_the_cartpole_pendulum_config_shrunk(tmp_path):
    cfgs = copy.deepcopy(port_configs("cartpole_pendulum_balance"))
    for c in cfgs:
        c.exp_name = str(tmp_path / "exp")
        c.env.update(collector_env_num=2, evaluator_env_num=2, max_episode_steps=12)
        c.policy.model.update(embed_dim=16, num_heads=2)
        c.policy.update(num_simulations=3, batch_size=8, update_per_collect=2, eval_freq=1000)
    policy, state, stats = entry.train_multitask_balance(cfgs, seed=0, max_train_iter=2,
                                                         device="cpu")
    # the plain type binds no task view: both tasks run as task 0
    assert not hasattr(policy, "task_view")
    assert all(b.policy is policy for b in stats["buffers"].values())
    assert stats["train_iter"] == 2 and all(torch.isfinite(p).all()
                                            for p in state.model.parameters())
    assert stats["buffers"][1].num_transitions > 0


def test_train_muzero_refuses_the_multitask_types_as_jax_fails_on_them(tmp_path):
    from lightzero_tpu.entry.train_muzero import train_muzero as jax_train_muzero

    cfg = shrunk_cartpole(tmp_path / "jax", "muzero_multitask", tasks=1)[0]
    cfg.policy.update(num_simulations=2, batch_size=8)
    with pytest.raises(AttributeError, match="has no attribute 'task_id'"):
        jax_train_muzero(JaxConfig(cfg.to_dict()), seed=0, max_train_iter=1)
    cfg.exp_name = str(tmp_path / "port")
    with pytest.raises(ValueError, match="AttributeError.*train_muzero_multitask"):
        entry.train_muzero(cfg, device="cpu")


def test_multitask_entry_aliases():
    assert entry.train_muzero_multitask_segment_ddp is entry.train_muzero_multitask
    assert entry.train_unizero_multitask_segment_ddp is entry.train_muzero_multitask
    assert entry.train_unizero_multitask_balance_segment_ddp is entry.train_multitask_balance
