"""Multitask training (``lightzero_tpu/entry/train_muzero_multitask.py``): one
shared policy trained across several tasks, each with its own envs,
collector, evaluator and replay buffer.

Loop: [eval every ``eval_freq`` train iterations: each task's return,
gathered over the processes, and the human-normalized mean and median where
the task names resolve to a benchmark table] -> collect ``n_episode``
episodes per task -> once every buffer holds ``batch_size / num_tasks``
transitions, ``update_per_collect`` learn steps on one combined batch of
``batch_size / num_tasks`` rows per task -> until ``max_env_step`` or
``max_train_iter``.

A multitask policy type (``muzero_multitask``, ``unizero_multitask``,
``sampled_unizero_multitask``) gets the rows' task ids and the task weights
(``compute_task_weights``: harder tasks weigh more) on the batch, and each
task's collector, evaluator and buffer a ``task_view`` of the policy; a
plain type folds each task's weight into its rows' importance weights.

Across processes (``parallel.distributed``) the tasks are partitioned
statically and each process collects, evaluates and trains its own; the
returns are all-gathered, so every process computes the same task weights.
As in the JAX entry, the processes' gradients are not synchronised (ROADMAP
queue 3); ``parallel.ddp.ddp_learn_step`` is the synchronised learn step.

Usage (on the card, or with ``device="cpu"``)::

    from lightzero_tpu_torch.configs.pendulum_suite_scalezero_v3 import task_configs
    from lightzero_tpu_torch.entry import train_muzero_multitask
    policy, state, stats = train_muzero_multitask(task_configs, seed=0, max_env_step=300_000)
"""
from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from lightzero_tpu_torch.buffers import GameBuffer
from lightzero_tpu_torch.config import Config, compile_config
from lightzero_tpu_torch.entry.train_muzero import POLICIES, tensor_env
from lightzero_tpu_torch.ops import visit_count_temperature
from lightzero_tpu_torch.parallel.distributed import (
    all_gather_scalars,
    init_distributed,
    partition_tasks,
)
from lightzero_tpu_torch.policy import MuZeroMTPolicy, SampledUniZeroMTPolicy, UniZeroMTPolicy
from lightzero_tpu_torch.policy.multitask import attach_task_fields
from lightzero_tpu_torch.utils.benchmark_scores import normalized_stats
from lightzero_tpu_torch.utils.checkpoint import save_checkpoint
from lightzero_tpu_torch.utils.device import resolve_device
from lightzero_tpu_torch.utils.logger import ExperimentLogger
from lightzero_tpu_torch.workers import Evaluator, RolloutCollector

# cfg.policy.type -> the policy the multitask entries build: the multitask
# types, and the single-task types with the task weights in the IS weights
MULTITASK_ENTRY_POLICIES = dict(
    POLICIES, muzero_multitask=MuZeroMTPolicy, unizero_multitask=UniZeroMTPolicy,
    sampled_unizero_multitask=SampledUniZeroMTPolicy)


def compute_task_weights(returns: Dict[int, float], targets: Dict[int, float],
                         temperature: float = 1.0) -> Dict[int, float]:
    """Symlog distance-to-target weighting: a task further below its target
    weighs more; the weights' mean is 1."""
    dists = {}
    for t, r in returns.items():
        dists[t] = np.log1p(max(targets.get(t, 1.0) - r, 0.0))
    vals = np.asarray(list(dists.values()), np.float64)
    if vals.sum() <= 0:
        return {t: 1.0 for t in returns}
    w = np.exp(vals / temperature)
    w = w / w.mean()
    return {t: float(w[i]) for i, t in enumerate(dists)}


def compile_task_configs(cfgs, policy_type_default: str, seed: int):
    """(the task configs, the first's compiled config, the policy class):
    the first task's policy defines the shared policy."""
    cfgs = [Config(copy.deepcopy(dict(c))) for c in cfgs]
    policy_type = cfgs[0].get("policy", {}).get("type", policy_type_default)
    if policy_type not in MULTITASK_ENTRY_POLICIES:
        raise NotImplementedError(f"policy type {policy_type!r} is not ported (ROADMAP queue 1)")
    policy_cls = MULTITASK_ENTRY_POLICIES[policy_type]
    cfg0 = compile_config(cfgs[0], policy_cls.default_config(), seed)
    if "task_num" in cfg0.policy:
        cfg0.policy.task_num = len(cfgs)
    return cfgs, cfg0, policy_cls


def combine_task_batches(parts: list, order: List[int], per_task_bs: int,
                         task_weights: np.ndarray, is_mt: bool):
    """One batch of the tasks' samples in ``order``; with the rows' task ids
    and the task weights for a multitask policy."""
    def cat(*xs):
        if xs[0] is None:
            return None
        if torch.is_tensor(xs[0]):
            return torch.cat(xs, dim=0)
        return type(xs[0])(*(cat(*ys) for ys in zip(*xs)))

    combined = cat(*parts)
    if is_mt:
        task_id = np.repeat(np.asarray(order, np.int64), per_task_bs)
        combined = attach_task_fields(combined, task_id, task_weights)
    return combined


def learn_on_tasks(policy, state, buffers: dict, order: List[int], per_task_bs: int,
                   weights: Dict[int, float], num_tasks: int, is_mt: bool):
    """One learn step on a combined batch of ``per_task_bs`` fresh samples
    of each task in ``order``; the priorities go back to each task's
    buffer. Returns (state, logs)."""
    task_weight_arr = np.asarray([weights.get(t, 1.0) for t in range(num_tasks)], np.float32)
    parts, idxs = [], []
    for ti in order:
        batch, idx = buffers[ti].sample(per_task_bs, state.target_model)
        if not is_mt:
            base = getattr(batch, "base", batch)
            base = base._replace(weights=base.weights * weights.get(ti, 1.0))
            batch = batch._replace(base=base) if hasattr(batch, "base") else base
        parts.append(batch)
        idxs.append(idx)
    combined = combine_task_batches(parts, order, per_task_bs, task_weight_arr, is_mt)
    state, logs, priority = policy.forward_learn(state, combined)
    priority = priority.detach().cpu().numpy()
    for j, ti in enumerate(order):
        buffers[ti].update_priority(idxs[j], priority[j * per_task_bs:(j + 1) * per_task_bs])
    return state, logs


def train_muzero_multitask(
    cfgs,
    seed: int = 0,
    max_env_step: int = int(1e6),
    max_train_iter: int = int(1e9),
    device: Optional[Union[str, torch.device]] = None,
):
    """Train one policy on the tasks of ``cfgs`` (one config per task; the
    first one's policy is the shared policy, and every task shares its
    observation and action spaces). Runs on ``device``: ``cuda`` unless the
    caller names another.

    Returns ``(policy, state, stats)``: ``stats`` holds ``env_steps``,
    ``train_iter``, ``task_returns``, and per task ``task_env_steps`` (the
    collector's), ``eval_env_steps`` (the evaluator's batched steps over
    all evals) and ``buffers``."""
    dev = resolve_device(device)
    cfgs, cfg0, policy_cls = compile_task_configs(cfgs, "muzero", seed)
    pcfg = cfg0.policy
    num_tasks = len(cfgs)

    init_distributed()
    local_tasks = list(partition_tasks(num_tasks))

    policy = policy_cls(pcfg, device=dev, seed=seed)
    state = policy.init_train_state()
    is_mt = hasattr(policy, "task_view")
    task_policies = [policy.task_view(t) if is_mt else policy for t in range(num_tasks)]

    collectors, evaluators, buffers, stop_values = {}, {}, {}, {}
    for ti in local_tasks:
        c = cfgs[ti]
        env = tensor_env(c.env, "train_muzero_multitask")
        collectors[ti] = RolloutCollector(env, task_policies[ti], c.env.get("collector_env_num", 4),
                                          seed=seed + 1 + 2 * ti, device=dev)
        evaluators[ti] = Evaluator(env, task_policies[ti], c.env.get("evaluator_env_num", 2),
                                   seed=seed + 2 + 2 * ti, device=dev)
        buffers[ti] = GameBuffer(pcfg, task_policies[ti])
    for ti, c in enumerate(cfgs):
        stop_values[ti] = float(c.env.get("stop_value", 1e9))

    logger = ExperimentLogger(cfg0.exp_name, "train")
    per_task_bs = max(1, int(pcfg.batch_size) // num_tasks)
    n_episode = int(pcfg.get("n_episode", 4))
    upc = int(pcfg.get("update_per_collect", 50))
    eval_freq = int(pcfg.get("eval_freq", 100))
    train_iter = 0
    last_eval = -eval_freq - 1
    task_returns: Dict[int, float] = {t: 0.0 for t in range(num_tasks)}
    eval_env_steps = {t: 0 for t in local_tasks}

    def total_env_steps():
        return sum(c.total_env_steps for c in collectors.values())

    while total_env_steps() < max_env_step and train_iter < max_train_iter:
        temperature = visit_count_temperature(
            pcfg.get("manual_temperature_decay", False),
            pcfg.get("fixed_temperature_value", 1.0),
            pcfg.get("threshold_training_steps_for_final_temperature", int(1e5)),
            train_iter,
        )
        if train_iter - last_eval >= eval_freq:
            last_eval = train_iter
            for ti, ev in evaluators.items():
                res = ev.eval()
                task_returns[ti] = res["mean_return"]
                eval_env_steps[ti] += res["env_steps"]
                logger.info(f"iter={train_iter} task{ti} EVAL return={res['mean_return']:.1f}")
            # every process sees every task's latest return: each reports
            # all tasks, NaN for those it does not own
            gathered = all_gather_scalars({
                f"task{t}": (task_returns[t] if t in local_tasks else float("nan"))
                for t in range(num_tasks)})
            for t in range(num_tasks):
                vals = gathered[f"task{t}"]
                if t not in local_tasks and np.any(np.isfinite(vals)):
                    task_returns[t] = float(np.nanmax(vals))
            hn_mean, hn_median = normalized_stats({
                str(cfgs[t].env.get("task_name", cfgs[t].env.get("type", t))):
                    task_returns.get(t)
                for t in range(num_tasks)
            }, benchmark=str(pcfg.get("benchmark_name", "atari")))
            if hn_mean is not None:
                logger.info(f"iter={train_iter} human_norm mean={hn_mean:.3f} "
                            f"median={hn_median:.3f}")
        for ti, coll in collectors.items():
            episodes, priorities, _ = coll.collect(temperature=temperature,
                                                   num_episodes=n_episode)
            buffers[ti].push_episodes(episodes, priorities)
        if any(b.num_transitions < per_task_bs for b in buffers.values()):
            continue
        # deterministic given the gathered returns: every process computes
        # the same weights
        weights = compute_task_weights(task_returns, dict(stop_values))
        logs: Dict = {}
        for _ in range(upc):
            state, logs = learn_on_tasks(policy, state, buffers, sorted(buffers), per_task_bs,
                                         weights, num_tasks, is_mt)
            train_iter += 1
        logger.log_scalars(logs, total_env_steps(), prefix="learner/")
        logger.info(f"iter={train_iter} envsteps={total_env_steps()} "
                    f"loss={float(logs.get('total_loss', 0)):.3f} weights={weights}")
    save_checkpoint(state, os.path.join(cfg0.exp_name, "ckpt", "ckpt_final"))
    logger.close()
    return policy, state, dict(
        env_steps=total_env_steps(), train_iter=train_iter, task_returns=task_returns,
        task_env_steps={t: c.total_env_steps for t, c in collectors.items()},
        eval_env_steps=eval_env_steps, buffers=buffers)
