"""Deterministic evaluator (``lightzero_tpu/workers/evaluator.py``): batched
episodes with argmax actions and no root noise; tracks the best mean return.

Deviations from the JAX evaluator: it takes a ``seed`` for the env resets
where the JAX one falls back to a fixed ``PRNGKey(1234)``; and it steps one
batched env step at a time (the JAX one scans ``rollout_length`` steps per
compiled call), stopping once every env has finished an episode and at least
``n_episodes`` episodes have ended. So with ``save_replay_path`` it writes
a replay for every episode that ended before it stopped, which may be more
than ``n_episodes``.

A policy with ``stateful_collect`` (MuZero-Context) is evaluated through
``_forward_collect_stateful`` with ``deterministic=True``, its per-env state
threaded through the steps and reset per env when an episode ends, as the
JAX evaluator does (evaluator.py:40-72).
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from lightzero_tpu_torch.envs.base import TensorEnv
from lightzero_tpu_torch.utils.device import resolve_device


def record(replay, obs: torch.Tensor, action: torch.Tensor, reward: torch.Tensor) -> None:
    """Append each env's observation, action and reward of one batched
    step to its trajectory in ``replay``, with the JAX evaluator's dtypes:
    float32 observations and rewards, int32 actions of a discrete space."""
    obs = obs.cpu().numpy().astype(np.float32)
    action = action.cpu().numpy()
    if not np.issubdtype(action.dtype, np.floating):
        action = action.astype(np.int32)
    reward = reward.cpu().numpy().astype(np.float32)
    for e, traj in enumerate(replay):
        traj["obs"].append(obs[e])
        traj["actions"].append(action[e])
        traj["rewards"].append(reward[e])


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
        """One batched env step: (the env's step, the policy's next state,
        the actions taken)."""
        if collect_state is None:
            out = self.policy.forward_eval(obs, legal, to_play)
        else:
            out, collect_state = self.policy._forward_collect_stateful(
                obs, legal, to_play, 1.0, 0.0, collect_state, deterministic=True)
        step = self.env.step(state, out["action"].to(self.device), self.generator)
        if collect_state is not None:
            collect_state = self.policy.reset_collect_state(collect_state, step.done)
        return step, collect_state, out["action"]

    def eval(self, n_episodes: Optional[int] = None, max_steps: int = 10_000,
             save_replay_path: Optional[str] = None) -> Dict:
        """Step every env until each has finished one episode and at least
        ``n_episodes`` (default: one per env) have ended, or ``max_steps``.
        With ``save_replay_path``, each finished episode's trajectory is
        written there as ``episode_<i>.npz`` (i counts the episodes in the
        order they end), with the JAX evaluator's keys: ``obs``, ``actions``,
        ``rewards`` and ``episode_return`` (reference
        deploy(enable_save_replay), agent/muzero.py:267)."""
        t0 = time.time()
        n_episodes = n_episodes or self.num_envs
        replay = None
        if save_replay_path is not None:
            os.makedirs(save_replay_path, exist_ok=True)
            replay = [dict(obs=[], actions=[], rewards=[]) for _ in range(self.num_envs)]
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
            step, collect_state, action = self._rollout_step(state, obs, legal, to_play,
                                                             collect_state)
            if replay is not None:
                record(replay, obs, action, step.reward)
            state, obs, legal, to_play = step.state, step.obs, step.legal_mask, step.to_play
            steps += 1
            reward = step.reward.cpu().numpy()
            done = step.done.cpu().numpy()
            acc += reward
            for e in np.flatnonzero(done):
                if replay is not None:
                    np.savez_compressed(
                        os.path.join(save_replay_path, f"episode_{len(returns)}.npz"),
                        obs=np.asarray(replay[e]["obs"]), actions=np.asarray(replay[e]["actions"]),
                        rewards=np.asarray(replay[e]["rewards"]), episode_return=acc[e] + 0.0)
                    replay[e] = dict(obs=[], actions=[], rewards=[])
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
