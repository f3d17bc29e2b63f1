"""Collector and evaluator over host envs (``lightzero_tpu/workers/host_collector.py``):
envs with the ``HostVecEnv`` interface (``envs/host_env.py``), stepped in
numpy on the host. Each batched env step runs one batched search for every
env on the policy's device, then reads the step's outputs back to the host
in one copy (``read_back``), and steps the envs with the actions.

As in ``workers/collector.py``, the search's and the action's randomness
come from the policy's ``torch.Generator`` on the device; the envs draw
theirs from their own seeds.

``HostCollector.collect`` runs in episode mode (``num_episodes``: until that
many episodes have ended, counted after each batched step) or ``min_steps``
mode (until that many env steps are taken); partial episodes stay in their
builders across calls, and none is flushed. Every finished episode is
recorded as not truncated (``truncated=False``), also where the env's time
limit cut it, as the JAX collector records it (ROADMAP queue 3). With
neither mode it takes one batched step (the JAX collector loops forever).
The stats are the JAX collector's: ``steps``, ``episodes``, ``duration``,
``steps_per_sec``, ``mean_return`` (of the last 20 episodes).

``HostEvaluator.eval`` steps every env with the argmax action and no root
noise until ``n_episodes`` episodes have ended (or ``max_steps`` batched
steps) and returns the JAX evaluator's record plus ``env_steps``, the
batched steps taken. A policy with ``stateful_collect`` (MuZero-Context,
UniZero) is served through ``_forward_collect_stateful``, its per-env state
reset where an episode ended, in both.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from lightzero_tpu_torch.utils.device import resolve_device
from lightzero_tpu_torch.workers.collector import _EpisodeBuilder


def read_back(out: Dict) -> Dict[str, np.ndarray]:
    """A search step's outputs on the host: every tensor copied at once
    (asynchronous copies into pinned memory on the card) and one wait."""
    host = {k: v.to("cpu", non_blocking=True) if torch.is_tensor(v) else v
            for k, v in out.items()}
    devices = {v.device for v in out.values() if torch.is_tensor(v) and v.is_cuda}
    for device in devices:
        torch.cuda.current_stream(device).synchronize()
    return {k: v.numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in host.items()}


class _HostWorker:
    def __init__(self, env, policy, device: Optional[Union[str, torch.device]] = None):
        """Runs on ``device``: ``cuda`` unless the caller names another."""
        self.env = env
        self.policy = policy
        self.num_envs = env.num_envs
        self.device = resolve_device(device)
        self.stateful = getattr(policy, "stateful_collect", False)

    @torch.no_grad()
    def _search(self, obs, legal, to_play, temperature: float, epsilon: float,
                deterministic: bool, collect_state=None):
        """One batched search over the envs' observations: (the outputs on
        the host, the policy's next per-env state)."""
        args = (torch.as_tensor(obs, device=self.device),
                torch.as_tensor(legal, device=self.device),
                torch.as_tensor(to_play, dtype=torch.int32, device=self.device),
                float(temperature), float(epsilon))
        if self.stateful:
            out, collect_state = self.policy._forward_collect_stateful(
                *args, collect_state, deterministic=deterministic)
        else:
            out = self.policy._forward_collect(*args, deterministic=deterministic)
        return read_back(out), collect_state

    def _reset_state(self, collect_state, dones: np.ndarray):
        if self.stateful and dones.any():
            return self.policy.reset_collect_state(
                collect_state, torch.as_tensor(dones, device=self.device))
        return collect_state


class HostCollector(_HostWorker):
    def __init__(self, env, policy, device: Optional[Union[str, torch.device]] = None):
        super().__init__(env, policy, device)
        self._builders = [_EpisodeBuilder() for _ in range(self.num_envs)]
        self.total_env_steps = 0
        self.total_episodes = 0
        self.episode_returns: List[float] = []
        self._env_return = np.zeros(self.num_envs)
        self._obs = None
        self._collect_state = None

    def collect(self, temperature: float = 1.0, epsilon: float = 0.0,
                num_episodes: Optional[int] = None, min_steps: Optional[int] = None):
        """Collect until ``num_episodes`` episodes have ended (or
        ``min_steps`` env steps are taken): (episodes, priorities, stats)."""
        t0 = time.time()
        if self._obs is None:
            self._obs, self._legal, self._to_play = self.env.reset_all()
            if self.stateful:
                self._collect_state = self.policy.init_collect_state(self.num_envs)
        episodes, priorities = [], []
        steps = 0
        while True:
            out, self._collect_state = self._search(
                self._obs, self._legal, self._to_play, temperature, epsilon, False,
                self._collect_state)
            next_obs, rewards, dones, next_legal, next_to_play = self.env.step(out["action"])
            pri = np.abs(out["predicted_value"] - out["searched_value"])
            sampled = out.get("root_sampled_actions")
            for e in range(self.num_envs):
                a = out["action"][e]
                self._builders[e].append(
                    self._obs[e], a if a.ndim > 0 else int(a), float(rewards[e]),
                    out["visit_counts"][e], float(out["searched_value"][e]), self._legal[e],
                    int(self._to_play[e]), float(pri[e]),
                    root_sampled_actions=None if sampled is None else sampled[e],
                )
                self._env_return[e] += float(rewards[e])
                if dones[e]:
                    ep, p = self._builders[e].finish(truncated=False)
                    episodes.append(ep)
                    priorities.append(p)
                    self.episode_returns.append(self._env_return[e])
                    self._env_return[e] = 0.0
                    self.total_episodes += 1
                    self._builders[e] = _EpisodeBuilder()
            self._collect_state = self._reset_state(self._collect_state, dones)
            self._obs, self._legal, self._to_play = next_obs, next_legal, next_to_play
            steps += self.num_envs
            self.total_env_steps += self.num_envs
            if num_episodes is not None and len(episodes) >= num_episodes:
                break
            if min_steps is not None and steps >= min_steps:
                break
            if num_episodes is None and min_steps is None:
                break
        duration = time.time() - t0
        stats = dict(
            steps=steps,
            episodes=len(episodes),
            duration=duration,
            steps_per_sec=steps / max(duration, 1e-9),
            mean_return=(float(np.mean(self.episode_returns[-20:]))
                         if self.episode_returns else 0.0),
        )
        return episodes, priorities, stats


class HostEvaluator(_HostWorker):
    def __init__(self, env, policy, device: Optional[Union[str, torch.device]] = None):
        super().__init__(env, policy, device)
        self.best_return = -np.inf

    def eval(self, n_episodes: Optional[int] = None, max_steps: int = 20_000) -> Dict:
        t0 = time.time()
        n_episodes = n_episodes or self.num_envs
        obs, legal, to_play = self.env.reset_all()
        collect_state = self.policy.init_collect_state(self.num_envs) if self.stateful else None
        returns: List[float] = []
        acc = np.zeros(self.num_envs)
        steps = 0
        while len(returns) < n_episodes and steps < max_steps:
            out, collect_state = self._search(obs, legal, to_play, 1.0, 0.0, True, collect_state)
            obs, rewards, dones, legal, to_play = self.env.step(out["action"])
            steps += 1
            for e in range(self.num_envs):
                acc[e] += rewards[e]
                if dones[e]:
                    returns.append(acc[e])
                    acc[e] = 0.0
            collect_state = self._reset_state(collect_state, dones)
        returns = returns[:n_episodes]
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
