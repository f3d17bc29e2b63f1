"""Curriculum and balance multitask training
(``lightzero_tpu/entry/train_multitask_balance.py``).

On top of the multitask entry (one shared policy, each task's envs and
buffer, symlog task weights) it adds:

- a solved pool: a task counts as solved after ``solved_patience``
  consecutive evals at or above its ``env.solved_threshold`` (default:
  ``env.stop_value``); a solved task stops collecting, is evaluated again
  with the others and rejoins when it falls below; once every task is
  solved the run stops after that round's learn steps, or at once when no
  buffer holds a batch yet (where the JAX entry loops forever, ROADMAP
  queue 3);
- curriculum stages: when at least ``policy.stage_solved_frac`` of the tasks
  are solved and the model has CurriculumLoRA (``lora_r`` > 0 and more than
  one stage), the stage advances (``set_curriculum_stage``): the transformer
  backbone freezes, the stage's adapters train, and the optimizer starts
  afresh over the new trainable set;
- ``ckpt_best`` and ``params_best`` on a new best cross-task mean return,
  a checkpoint every ``save_ckpt_freq`` iterations with
  ``ckpt/resume_meta.json`` (the stage included), which ``auto_resume``
  reads; the buffers refill by fresh self-play;
- ``env.pad_obs_to``: a task's vector observations zero-padded to a common
  width (``PadVectorObs``).

Deliberate difference: after a stage advance the JAX entry builds new
collectors and evaluators (its jitted closures hold the old stage), whose
env-step counters start again at 0, so its run overshoots ``max_env_step``
(ROADMAP queue 3). Here every task view shares the model, whose stage
switches in place, and the workers and their counters carry on. A resume at
a stage above 0 restores the saved optimizer, which holds that stage's
trainable set; the JAX entry starts a fresh optimizer state there.

Usage (on the card, or with ``device="cpu"``)::

    from lightzero_tpu_torch.configs.pendulum_suite_scalezero_v3 import task_configs
    from lightzero_tpu_torch.entry import train_multitask_balance
    policy, state, stats = train_multitask_balance(task_configs, seed=0, max_env_step=300_000)
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Union

import torch

from lightzero_tpu_torch.buffers import GameBuffer
from lightzero_tpu_torch.entry.train_muzero import tensor_env
from lightzero_tpu_torch.entry.train_muzero_multitask import (
    compile_task_configs,
    compute_task_weights,
    learn_on_tasks,
)
from lightzero_tpu_torch.envs.wrappers import PadVectorObs
from lightzero_tpu_torch.ops import visit_count_temperature
from lightzero_tpu_torch.utils.benchmark_scores import normalized_stats
from lightzero_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    save_params_export,
)
from lightzero_tpu_torch.utils.device import resolve_device
from lightzero_tpu_torch.utils.logger import ExperimentLogger
from lightzero_tpu_torch.workers import Evaluator, RolloutCollector


def train_multitask_balance(
    cfgs,
    seed: int = 0,
    max_env_step: int = int(1e6),
    max_train_iter: int = int(1e9),
    device: Optional[Union[str, torch.device]] = None,
):
    """Train one policy on the tasks of ``cfgs`` (one config per task; the
    first one's policy is the shared policy) with the solved pool and the
    curriculum stages. Runs on ``device``: ``cuda`` unless the caller names
    another.

    Returns ``(policy, state, stats)``: ``stats`` holds ``env_steps``,
    ``train_iter``, ``task_returns``, ``stage``, ``solved``, and per task
    ``task_env_steps``, ``eval_env_steps`` and ``buffers``."""
    dev = resolve_device(device)
    cfgs, cfg0, policy_cls = compile_task_configs(cfgs, "unizero", seed)
    pcfg = cfg0.policy
    num_tasks = len(cfgs)

    policy = policy_cls(pcfg, device=dev, seed=seed)
    state = policy.init_train_state()
    # the multitask types bind each worker's task, so that the model's task
    # embedding conditions its collect, eval and buffer
    is_mt = hasattr(policy, "task_view")
    task_policies = [policy.task_view(t) if is_mt else policy for t in range(num_tasks)]
    collectors, evaluators = [], []
    for ti, c in enumerate(cfgs):
        env = tensor_env(c.env, "train_multitask_balance")
        if c.env.get("pad_obs_to"):
            env = PadVectorObs(env, int(c.env.pad_obs_to))
        collectors.append(RolloutCollector(env, task_policies[ti],
                                           c.env.get("collector_env_num", 4),
                                           seed=seed + 1 + 2 * ti, device=dev))
        evaluators.append(Evaluator(env, task_policies[ti], c.env.get("evaluator_env_num", 2),
                                    seed=seed + 2 + 2 * ti, device=dev))
    buffers = {t: GameBuffer(pcfg, task_policies[t]) for t in range(num_tasks)}
    solved_thresholds = [
        float(c.env.get("solved_threshold", c.env.get("stop_value", 1e9))) for c in cfgs]
    stop_values = [float(c.env.get("stop_value", 1e9)) for c in cfgs]

    logger = ExperimentLogger(cfg0.exp_name, "train")
    ckpt_dir = os.path.join(cfg0.exp_name, "ckpt")
    per_task_bs = max(1, int(pcfg.batch_size) // num_tasks)
    n_episode = int(pcfg.get("n_episode", 4))
    upc = int(pcfg.get("update_per_collect", 50))
    eval_freq = int(pcfg.get("eval_freq", 100))
    stage_solved_frac = float(pcfg.get("stage_solved_frac", 0.5))
    max_stage = int(pcfg.model.get("curriculum_stage_num", 1)) - 1
    lora_on = int(pcfg.model.get("lora_r", 0)) > 0 and max_stage > 0

    train_iter = 0
    env_step_base = 0
    last_eval = -eval_freq - 1
    best_mean_return = -float("inf")
    stage = int(pcfg.model.get("curriculum_stage", 0))
    solved: Dict[int, bool] = {t: False for t in range(num_tasks)}
    task_returns: Dict[int, float] = {t: -1e9 for t in range(num_tasks)}
    eval_env_steps = {t: 0 for t in range(num_tasks)}
    meta_path = os.path.join(ckpt_dir, "resume_meta.json")
    if pcfg.get("auto_resume", False) and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        ckpt = os.path.join(ckpt_dir, str(meta["last_ckpt"]))
        if os.path.exists(ckpt + ".pt"):
            stage = int(meta.get("stage", stage))
            if stage > 0 and lora_on:
                # the saved optimizer holds the stage's trainable set
                state = policy.set_curriculum_stage(stage, state)
            state = load_checkpoint(ckpt, target=state)
            train_iter = int(meta["train_iter"])
            env_step_base = int(meta["env_steps"])
            logger.info(f"auto_resume: restored {meta['last_ckpt']} (iter={train_iter} "
                        f"envstep={env_step_base} stage={stage})")
    # a task counts as solved only after solved_patience consecutive evals
    # at its threshold: with few-episode evals one lucky eval would
    # otherwise freeze the backbone before the task is learned
    solved_patience = int(pcfg.get("solved_patience", 2))
    solved_streak: Dict[int, int] = {t: 0 for t in range(num_tasks)}

    def total_env_steps():
        return env_step_base + sum(c.total_env_steps for c in collectors)

    while total_env_steps() < max_env_step and train_iter < max_train_iter:
        temperature = visit_count_temperature(
            pcfg.get("manual_temperature_decay", False),
            pcfg.get("fixed_temperature_value", 1.0),
            pcfg.get("threshold_training_steps_for_final_temperature", int(1e5)),
            train_iter,
        )
        if train_iter - last_eval >= eval_freq:
            last_eval = train_iter
            for ti, ev in enumerate(evaluators):
                res = ev.eval()
                task_returns[ti] = res["mean_return"]
                eval_env_steps[ti] += res["env_steps"]
                was = solved[ti]
                if res["mean_return"] >= solved_thresholds[ti]:
                    solved_streak[ti] += 1
                else:
                    solved_streak[ti] = 0
                solved[ti] = solved_streak[ti] >= solved_patience
                if solved[ti] != was:
                    logger.info(f"task{ti} {'SOLVED' if solved[ti] else 'regressed'} "
                                f"(return={res['mean_return']:.1f})")
            logger.log_scalars(
                {f"task{ti}/eval_mean_return": task_returns[ti] for ti in range(num_tasks)},
                total_env_steps(), prefix="evaluator/")
            logger.info("EVAL " + " ".join(f"task{ti}={task_returns[ti]:.1f}"
                                           for ti in range(num_tasks)))
            # best checkpoint on the cross-task mean: the full checkpoint
            # for a resume, the params export for a re-eval
            cur_mean = sum(task_returns.values()) / num_tasks
            if cur_mean > best_mean_return and all(r > -1e8 for r in task_returns.values()):
                best_mean_return = cur_mean
                save_checkpoint(state, os.path.join(ckpt_dir, "ckpt_best"))
                save_params_export(state, os.path.join(ckpt_dir, "params_best"))
                logger.info(f"new best mean return {cur_mean:.1f} -> ckpt_best")
            hn_mean, hn_median = normalized_stats({
                str(cfgs[ti].env.get("task_name", cfgs[ti].env.get("type", ti))):
                    (None if task_returns[ti] <= -1e8 else task_returns[ti])
                for ti in range(num_tasks)
            }, benchmark=str(pcfg.get("benchmark_name", "atari")))
            if hn_mean is not None:
                logger.info(f"human_norm mean={hn_mean:.3f} median={hn_median:.3f}")
            frac = sum(solved.values()) / num_tasks
            if lora_on and stage < max_stage and frac >= stage_solved_frac:
                stage += 1
                logger.info(f"curriculum stage -> {stage} (solved frac {frac:.2f})")
                state = policy.set_curriculum_stage(stage, state)

        for ti, coll in enumerate(collectors):
            if solved[ti]:
                continue  # the solved pool collects no more
            episodes, priorities, _ = coll.collect(temperature=temperature,
                                                   num_episodes=n_episode)
            buffers[ti].push_episodes(episodes, priorities)
        active = [t for t in range(num_tasks) if buffers[t].num_transitions >= per_task_bs]
        if not active:
            if all(solved.values()):
                # every task solved before any buffer held a batch: nothing
                # can collect or train (the JAX entry loops forever here)
                logger.info("all tasks solved: stopping")
                break
            continue
        weights = compute_task_weights({t: task_returns[t] for t in active},
                                       {t: stop_values[t] for t in active})
        logs: Dict = {}
        for _ in range(upc):
            state, logs = learn_on_tasks(policy, state, buffers, active, per_task_bs, weights,
                                         num_tasks, is_mt)
            train_iter += 1
        logger.log_scalars(logs, total_env_steps(), prefix="learner/")
        logger.info(f"iter={train_iter} envsteps={total_env_steps()} stage={stage} "
                    f"solved={[t for t, s in solved.items() if s]} "
                    f"loss={float(logs.get('total_loss', 0)):.3f}")
        if train_iter % int(pcfg.get("save_ckpt_freq", 10_000)) < upc:
            name = f"iteration_{train_iter}"
            save_checkpoint(state, os.path.join(ckpt_dir, name))
            with open(meta_path, "w") as f:
                json.dump(dict(last_ckpt=name, train_iter=train_iter,
                               env_steps=int(total_env_steps()), stage=stage), f)
        if all(solved.values()):
            logger.info("all tasks solved: stopping")
            break
    save_checkpoint(state, os.path.join(ckpt_dir, "ckpt_final"))
    logger.close()
    return policy, state, dict(
        env_steps=total_env_steps(), train_iter=train_iter, task_returns=task_returns,
        stage=stage, solved=solved,
        task_env_steps={t: c.total_env_steps for t, c in enumerate(collectors)},
        eval_env_steps=eval_env_steps, buffers=buffers)
