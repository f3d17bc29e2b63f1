"""Offline sweep of a run's checkpoints (``lightzero_tpu/entry/eval_offline.py``):
every ``iteration_*``, ``ckpt_best`` and ``ckpt_final`` checkpoint under
``<exp_dir>/ckpt`` (the ``torch.save`` files of ``utils/checkpoint.py``), in
name order, loaded into one policy and evaluated by the deterministic
``Evaluator``; returns each checkpoint's mean return and the best.

It evaluates the tensor envs of ``create_env`` only: on a host env the JAX
``eval_offline`` hands create_env's None to its ``Evaluator`` and fails, and
the port refuses the config with a ``ValueError`` that says so.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Union

import torch

from lightzero_tpu_torch.config import Config, compile_config
from lightzero_tpu_torch.entry.train_muzero import (
    POLICIES,
    _check_scope,
    check_observation_shape,
    tensor_env,
)
from lightzero_tpu_torch.utils.checkpoint import load_checkpoint
from lightzero_tpu_torch.utils.device import resolve_device
from lightzero_tpu_torch.workers import Evaluator


def checkpoints(ckpt_dir: str) -> List[str]:
    """The sweep's checkpoint names under ``ckpt_dir``, in name order."""
    names = []
    for name in sorted(os.listdir(ckpt_dir)):
        stem = name[:-3] if name.endswith(".pt") else None
        if stem and (re.match(r"iteration_\d+", stem) or stem in ("ckpt_best", "ckpt_final")):
            names.append(stem)
    return names


def eval_offline(
    cfg,
    exp_dir: Optional[str] = None,
    seed: int = 0,
    n_episodes: int = 5,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict:
    """Evaluate every checkpoint of ``exp_dir`` (default ``cfg.exp_name``)
    on ``cfg.env.evaluator_env_num`` envs until ``n_episodes`` episodes have
    ended. Runs on ``device``: ``cuda`` unless the caller names another.
    Returns ``results`` (checkpoint name -> mean return), ``best_ckpt`` and
    ``best_return``."""
    if isinstance(cfg, (list, tuple)):
        cfg = cfg[0]
    dev = resolve_device(device)
    pcfg = Config(Config(cfg).get("policy", {}))
    _check_scope(pcfg)
    policy_cls = POLICIES[pcfg.get("type", "muzero")]
    cfg = compile_config(cfg, policy_cls.default_config(), seed, save_cfg=False)
    ckpt_dir = os.path.join(exp_dir or cfg.exp_name, "ckpt")
    names = checkpoints(ckpt_dir)
    assert names, f"no checkpoints under {ckpt_dir}"

    env = tensor_env(cfg.env, "eval_offline")
    check_observation_shape(env, cfg.policy, policy_cls)
    policy = policy_cls(cfg.policy, device=dev, seed=seed)
    state = policy.init_train_state()
    evaluator = Evaluator(env, policy, cfg.env.get("evaluator_env_num", 3), seed=seed,
                          device=dev)
    results = {}
    for name in names:
        load_checkpoint(os.path.join(ckpt_dir, name), target=state)
        results[name] = evaluator.eval(n_episodes=n_episodes)["mean_return"]
    best = max(results, key=results.get)
    return dict(results=results, best_ckpt=best, best_return=results[best])
