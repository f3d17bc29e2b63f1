"""Deterministic evaluator (``lightzero_tpu/workers/evaluator.py``): batched
episodes with argmax actions and no root noise; tracks the best mean return.

Deviations from the JAX evaluator: it takes a ``seed`` for the env resets
where the JAX one falls back to a fixed ``PRNGKey(1234)``; and it steps one
batched env step at a time (the JAX one scans ``rollout_length`` steps per
compiled call), stopping once every env has finished an episode and at least
``n_episodes`` episodes have ended.

A policy with ``stateful_collect`` (MuZero-Context) is evaluated through
``_forward_collect_stateful`` with ``deterministic=True``, its per-env state
threaded through the steps and reset per env when an episode ends, as the
JAX evaluator does (evaluator.py:40-72).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from lightzero_tpu_torch.envs.base import TensorEnv
from lightzero_tpu_torch.utils.device import resolve_device


class Evaluator:
    def __init__(
        self,
        env: TensorEnv,
        policy,
        num_envs: int = 3,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """Runs on ``device``: ``cuda`` unless the caller names another."""
        self.env = env
        self.policy = policy
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.best_return = -np.inf

    @torch.no_grad()
    def _rollout_step(self, state, obs, legal, to_play, collect_state=None):
        """One batched env step: (the env's step, the policy's next state)."""
        if collect_state is None:
            out = self.policy.forward_eval(obs, legal, to_play)
        else:
            out, collect_state = self.policy._forward_collect_stateful(
                obs, legal, to_play, 1.0, 0.0, collect_state, deterministic=True)
        step = self.env.step(state, out["action"].to(self.device), self.generator)
        if collect_state is not None:
            collect_state = self.policy.reset_collect_state(collect_state, step.done)
        return step, collect_state

    def eval(self, n_episodes: Optional[int] = None, max_steps: int = 10_000) -> Dict:
        """Step every env until each has finished one episode and at least
        ``n_episodes`` (default: one per env) have ended, or ``max_steps``."""
        t0 = time.time()
        n_episodes = n_episodes or self.num_envs
        state, obs = self.env.reset(self.num_envs, self.generator)
        legal = self.env.legal_mask(state)
        to_play = torch.full((self.num_envs,), -1, dtype=torch.int32, device=self.device)
        collect_state = (self.policy.init_collect_state(self.num_envs)
                         if getattr(self.policy, "stateful_collect", False) else None)
        returns = []
        finished = np.zeros(self.num_envs, bool)
        acc = np.zeros(self.num_envs)
        steps = 0
        while (len(returns) < n_episodes or not finished.all()) and steps < max_steps:
            step, collect_state = self._rollout_step(state, obs, legal, to_play, collect_state)
            state, obs, legal, to_play = step.state, step.obs, step.legal_mask, step.to_play
            steps += 1
            reward = step.reward.cpu().numpy()
            done = step.done.cpu().numpy()
            acc += reward
            for e in np.flatnonzero(done):
                returns.append(float(acc[e]))
                acc[e] = 0.0
                finished[e] = True
        mean_ret = float(np.mean(returns)) if returns else 0.0
        new_best = mean_ret > self.best_return
        if new_best:
            self.best_return = mean_ret
        return dict(
            episode_returns=returns,
            mean_return=mean_ret,
            max_return=float(np.max(returns)) if returns else 0.0,
            min_return=float(np.min(returns)) if returns else 0.0,
            new_best=new_best,
            env_steps=steps,
            duration=time.time() - t0,
        )
