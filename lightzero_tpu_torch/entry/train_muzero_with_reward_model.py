"""MuZero with the RND intrinsic reward
(``lightzero_tpu/entry/train_muzero_with_reward_model.py``): the training
loop of ``train_muzero`` with an ``RNDRewardModel`` over the observations.
For each collected episode, in order, the model takes one train step on the
episode's flattened observations and then estimates their intrinsic
rewards; the shaped rewards replace the episode's rewards before it enters
the buffer, so every target sees them.

The entry keeps the JAX entry's scope: the tensor envs of ``create_env``
only (a host env raises ``ValueError``, where the JAX entry fails), an eval
every ``eval_freq`` iterations that stops the run at ``stop_value``, the
collect temperature of ``fixed_temperature_value`` (default 1.0), episode
collection, ``update_per_collect`` (or a quarter of the collected steps)
learn steps once the buffer holds a batch, and one checkpoint,
``ckpt/ckpt_final``, at the end.

The intrinsic weight is read from ``cfg.policy.intrinsic_reward_weight``
(default 0.01), as the JAX entry reads it; ``cfg.reward_model`` is not read,
so the zoo's ``memory_muzero_rnd`` trains at 0.01 and not at the 0.003 its
``reward_model`` sets, in both packages (ROADMAP queue 3). ``model_path``
warm-starts the policy, which the JAX entry does not do.

Usage (on the card, or with ``device="cpu"``)::

    from lightzero_tpu_torch.configs.memory_muzero_rnd import main_config
    from lightzero_tpu_torch.entry import train_muzero_with_reward_model
    policy, state, stats = train_muzero_with_reward_model(main_config, seed=0)
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from lightzero_tpu_torch.buffers import GameBuffer
from lightzero_tpu_torch.config import Config, compile_config
from lightzero_tpu_torch.entry.train_muzero import (
    POLICIES,
    _check_scope,
    check_observation_shape,
    tensor_env,
)
from lightzero_tpu_torch.ops import visit_count_temperature
from lightzero_tpu_torch.reward_model import RNDRewardModel
from lightzero_tpu_torch.utils.checkpoint import load_checkpoint_lenient, save_checkpoint
from lightzero_tpu_torch.utils.device import resolve_device
from lightzero_tpu_torch.utils.logger import ExperimentLogger
from lightzero_tpu_torch.workers import Evaluator, RolloutCollector


def train_muzero_with_reward_model(
    cfg,
    seed: int = 0,
    model_path: Optional[str] = None,
    max_env_step: int = int(1e6),
    max_train_iter: int = int(1e9),
    device: Optional[Union[str, torch.device]] = None,
):
    """Train the policy of ``cfg.policy.type`` with RND-shaped rewards. Runs
    on ``device``: ``cuda`` unless the caller names another. The RND nets'
    weights are drawn from ``seed + 3``.

    Returns ``(policy, state, stats)``: ``stats`` holds ``env_steps``,
    ``train_iter``, ``eval_env_steps`` (the evaluator's batched steps over
    all evals), ``buffer``, ``reward_model`` and ``rnd_state``."""
    if isinstance(cfg, (list, tuple)):
        cfg = cfg[0]
    dev = resolve_device(device)
    pcfg = Config(Config(cfg).get("policy", {}))
    _check_scope(pcfg)
    policy_cls = POLICIES[pcfg.get("type", "muzero")]
    cfg = compile_config(cfg, policy_cls.default_config(), seed)
    pcfg = cfg.policy
    env = tensor_env(cfg.env, "train_muzero_with_reward_model")
    check_observation_shape(env, pcfg, policy_cls)
    policy = policy_cls(pcfg, device=dev, seed=seed)
    state = policy.init_train_state()
    if model_path:
        state = load_checkpoint_lenient(model_path, target=state)

    obs_dim = int(np.prod(np.atleast_1d(pcfg.model.observation_shape)))
    rnd = RNDRewardModel(obs_dim,
                         intrinsic_reward_weight=float(pcfg.get("intrinsic_reward_weight", 0.01)),
                         device=dev, seed=seed + 3)
    rnd_state = rnd.init_state()

    buffer = GameBuffer(pcfg, policy)
    collector = RolloutCollector(env, policy, cfg.env.get("collector_env_num", 8), seed=seed + 1,
                                 device=dev)
    evaluator = Evaluator(env, policy, cfg.env.get("evaluator_env_num", 3), seed=seed + 2,
                          device=dev)
    logger = ExperimentLogger(cfg.exp_name, "train")
    batch_size = int(pcfg.batch_size)
    train_iter = 0
    eval_freq = int(pcfg.get("eval_freq", 100))
    last_eval = -eval_freq - 1
    eval_env_steps = 0

    while collector.total_env_steps < max_env_step and train_iter < max_train_iter:
        temperature = visit_count_temperature(
            pcfg.get("manual_temperature_decay", False),
            pcfg.get("fixed_temperature_value", 1.0),
            pcfg.get("threshold_training_steps_for_final_temperature", int(1e5)),
            train_iter,
        )
        if train_iter - last_eval >= eval_freq:
            last_eval = train_iter
            res = evaluator.eval()
            eval_env_steps += res["env_steps"]
            logger.info(f"iter={train_iter} EVAL mean_return={res['mean_return']:.1f}")
            if res["mean_return"] >= cfg.env.get("stop_value", float("inf")):
                break
        episodes, priorities, cstats = collector.collect(
            temperature=temperature, num_episodes=int(pcfg.get("n_episode", 8)))
        # train RND on the fresh observations, then shape the episode's
        # rewards with the intrinsic bonus
        shaped = []
        for ep in episodes:
            flat_obs = ep.obs.reshape(len(ep.obs), -1)
            rnd_state, _ = rnd.train_step(rnd_state, flat_obs)
            rnd_state, new_rewards, _ = rnd.estimate(rnd_state, flat_obs, ep.rewards)
            shaped.append(ep._replace(rewards=new_rewards.cpu().numpy().astype(np.float32)))
        buffer.push_episodes(shaped, priorities)
        if buffer.num_transitions < batch_size:
            continue
        upc = int(pcfg.get("update_per_collect") or max(1, int(cstats["steps"] * 0.25)))
        logs = {}
        for _ in range(upc):
            batch, idx = buffer.sample(batch_size, state.target_model)
            state, logs, priority = policy.forward_learn(state, batch)
            buffer.update_priority(idx, priority.cpu().numpy())
            train_iter += 1
        logger.info(f"iter={train_iter} envstep={collector.total_env_steps} "
                    f"loss={float(logs.get('total_loss', 0)):.3f}")
    save_checkpoint(state, os.path.join(cfg.exp_name, "ckpt", "ckpt_final"))
    logger.close()
    return policy, state, dict(env_steps=collector.total_env_steps, train_iter=train_iter,
                               eval_env_steps=eval_env_steps, buffer=buffer, reward_model=rnd,
                               rnd_state=rnd_state)
