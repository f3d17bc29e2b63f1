"""Self-play collector (``lightzero_tpu/workers/collector.py``).

A rollout chunk is ``rollout_length`` batched steps of [initial inference ->
search -> action -> env step with auto-reset] for every env. The JAX
collector compiles a chunk into one ``lax.scan``; here the steps run
eagerly on the policy's device and the chunk's records are moved to the
host once, where they are sliced into finished episodes for the buffer.

Episode mode (``num_episodes``) collects whole chunks until that many
episodes have ended, so it can return more; segment mode (``min_steps``)
stops after that many env steps and flushes every partial episode of at
least ``flush_min_len`` steps as truncated. ``total_env_steps`` grows by
``rollout_length`` x ``num_envs`` per chunk in both.

Actions are stored as the policy gives them: ints, or (D,) floats in a
continuous action space. A sampled policy's root candidates
(``root_sampled_actions``, (K, D) or (K,) per step) go into the episode
record, and its telemetry (``visit_mean_action``, ``collect_mu``,
``collect_sigma``) into the stats, averaged over the last chunk.

A policy with ``stateful_collect`` (MuZero-Context) keeps a per-env state
across steps: the collector threads it through ``_forward_collect_stateful``
and resets it per env when an episode ends (collector.py:128-154).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from lightzero_tpu_torch.buffers.game_buffer import EpisodeRecord
from lightzero_tpu_torch.envs.base import TensorEnv
from lightzero_tpu_torch.utils.device import resolve_device

# the sampled policies' telemetry, recorded when the policy's output has it
_TELEMETRY_KEYS = ("visit_mean_action", "collect_mu", "collect_sigma")


class _EpisodeBuilder:
    """Accumulates one env's step records across rollout chunks."""

    def __init__(self, prefix_obs: Optional[np.ndarray] = None):
        # obs of the frame_stack-1 steps before this record's start (set when
        # a builder continues an episode that was flushed mid-way), so the
        # buffer's frame stacking does not zero-pad across the flush boundary
        self.prefix_obs = prefix_obs
        self.obs: List[np.ndarray] = []
        self.actions: List[Union[int, np.ndarray]] = []
        self.rewards: List[float] = []
        self.child_visits: List[np.ndarray] = []
        self.root_values: List[float] = []
        self.legal: List[np.ndarray] = []
        self.to_play: List[int] = []
        self.priorities: List[float] = []
        self.chance: List[int] = []
        self.root_sampled_actions: List[np.ndarray] = []

    def append(self, obs, action, reward, visits, root_value, legal, to_play, priority, chance=0,
               root_sampled_actions=None):
        self.obs.append(obs)
        self.actions.append(action)
        self.rewards.append(reward)
        self.child_visits.append(visits)
        self.root_values.append(root_value)
        self.legal.append(legal)
        self.to_play.append(to_play)
        self.priorities.append(priority)
        self.chance.append(chance)
        if root_sampled_actions is not None:
            self.root_sampled_actions.append(root_sampled_actions)

    def __len__(self):
        return len(self.actions)

    def finish(self, truncated: bool) -> Tuple[EpisodeRecord, np.ndarray]:
        visits = np.asarray(self.child_visits, np.float32)
        sums = visits.sum(-1, keepdims=True)
        actions = np.asarray(self.actions)
        continuous = actions.dtype.kind == "f" or actions.ndim > 1
        ep = EpisodeRecord(
            obs=np.asarray(self.obs, np.float32),
            actions=actions.astype(np.float32 if continuous else np.int64),
            rewards=np.asarray(self.rewards, np.float32),
            child_visits=visits / np.maximum(sums, 1e-9),
            root_values=np.asarray(self.root_values, np.float32),
            legal_mask=np.asarray(self.legal, bool),
            to_play=np.asarray(self.to_play, np.int64),
            truncated=truncated,
            chance=np.asarray(self.chance, np.int64),
            root_sampled_actions=(np.asarray(self.root_sampled_actions, np.float32)
                                  if self.root_sampled_actions else None),
            prefix_obs=self.prefix_obs,
        )
        return ep, np.asarray(self.priorities, np.float64)


class RolloutCollector:
    def __init__(
        self,
        env: TensorEnv,
        policy,
        num_envs: int,
        rollout_length: int = 64,
        seed: int = 0,
        flush_min_len: int = 8,
        frame_stack: int = 1,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """Runs on ``device``: ``cuda`` unless the caller names another. The
        env's randomness comes from a generator seeded with ``seed``; the
        search's and the action's from the policy's generator."""
        self.env = env
        self.policy = policy
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        # segment mode flushes partial episodes at least this long as
        # truncated, so that training can start before the first natural
        # episode end (reference MuZeroSegmentCollector)
        self.flush_min_len = flush_min_len
        self.frame_stack = frame_stack
        self.device = resolve_device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._builders = [_EpisodeBuilder() for _ in range(num_envs)]
        self.total_env_steps = 0
        self.total_episodes = 0
        self.episode_returns: List[float] = []
        self._env_return = np.zeros(num_envs)
        self._state = None
        self._collect_state = None  # the stateful policies' per-env state

    def _reset_all(self):
        state, obs = self.env.reset(self.num_envs, self.generator)
        legal = self.env.legal_mask(state)
        # the first roots' player comes from the env (collector.py:124-127):
        # the player to move in board self-play, -1 otherwise
        to_play = self.env.initial_to_play(state).to(self.device, torch.int32)
        return state, obs, legal, to_play

    @torch.no_grad()
    def _rollout(self, carry, temperature: float, epsilon: float):
        """``rollout_length`` search + env steps; the records as numpy
        arrays of shape (rollout_length, num_envs, ...)."""
        env_state, obs, legal, to_play = carry
        stateful = getattr(self.policy, "stateful_collect", False)
        if stateful and self._collect_state is None:
            self._collect_state = self.policy.init_collect_state(self.num_envs)
        records = []
        for _ in range(self.rollout_length):
            if stateful:
                out, self._collect_state = self.policy._forward_collect_stateful(
                    obs, legal, to_play, temperature, epsilon, self._collect_state,
                    deterministic=False,
                )
            else:
                out = self.policy._forward_collect(
                    obs, legal, to_play, temperature, epsilon, deterministic=False
                )
            step = self.env.step(env_state, out["action"], self.generator)
            if stateful:
                self._collect_state = self.policy.reset_collect_state(self._collect_state,
                                                                      step.done)
            chance = (step.chance if step.chance is not None
                      else torch.zeros_like(step.reward, dtype=torch.int64))
            records.append(dict(
                obs=obs, legal=legal, to_play=to_play, action=out["action"],
                reward=step.reward, done=step.done, truncated=step.truncated, chance=chance,
                visit_counts=out["visit_counts"], searched_value=out["searched_value"],
                predicted_value=out["predicted_value"],
                **{k: out[k] for k in ("root_sampled_actions",) + _TELEMETRY_KEYS if k in out},
            ))
            env_state, obs, legal, to_play = step.state, step.obs, step.legal_mask, step.to_play
        stacked = {k: torch.stack([r[k] for r in records]).cpu().numpy() for k in records[0]}
        return (env_state, obs, legal, to_play), stacked

    def collect(
        self,
        temperature: float = 1.0,
        epsilon: float = 0.0,
        num_episodes: Optional[int] = None,
        min_steps: Optional[int] = None,
    ) -> Tuple[List[EpisodeRecord], List[np.ndarray], Dict]:
        """Collect until ``num_episodes`` episodes finished (or ``min_steps``
        env steps taken). Returns (episodes, priorities, stats)."""
        t0 = time.time()
        if self._state is None:
            self._state = self._reset_all()
        episodes: List[EpisodeRecord] = []
        priorities: List[np.ndarray] = []
        steps_taken = 0
        while True:
            self._state, records = self._rollout(self._state, float(temperature), float(epsilon))
            T = self.rollout_length
            steps_taken += T * self.num_envs
            self.total_env_steps += T * self.num_envs
            pri = np.abs(records["predicted_value"] - records["searched_value"])
            for t in range(T):
                for e in range(self.num_envs):
                    b = self._builders[e]
                    action = records["action"][t, e]
                    b.append(
                        records["obs"][t, e],
                        action if action.ndim > 0 else int(action),
                        float(records["reward"][t, e]),
                        records["visit_counts"][t, e],
                        float(records["searched_value"][t, e]),
                        records["legal"][t, e],
                        int(records["to_play"][t, e]),
                        float(pri[t, e]),
                        chance=int(records["chance"][t, e]),
                        root_sampled_actions=(records["root_sampled_actions"][t, e]
                                              if "root_sampled_actions" in records else None),
                    )
                    self._env_return[e] += float(records["reward"][t, e])
                    if records["done"][t, e]:
                        ep, p = b.finish(truncated=bool(records["truncated"][t, e]))
                        episodes.append(ep)
                        priorities.append(p)
                        self.episode_returns.append(self._env_return[e])
                        self._env_return[e] = 0.0
                        self.total_episodes += 1
                        self._builders[e] = _EpisodeBuilder()
            if num_episodes is not None and len(episodes) >= num_episodes:
                break
            if min_steps is not None and steps_taken >= min_steps:
                # flush long enough partial episodes as truncated; the
                # successor builder keeps a frame-stack prefix
                for e in range(self.num_envs):
                    b = self._builders[e]
                    if len(b) >= self.flush_min_len:
                        ep, p = b.finish(truncated=True)
                        episodes.append(ep)
                        priorities.append(p)
                        prefix = ep.obs[-(self.frame_stack - 1):] if self.frame_stack > 1 else None
                        self._builders[e] = _EpisodeBuilder(prefix_obs=prefix)
                break
            if num_episodes is None and min_steps is None:
                break
        duration = time.time() - t0
        stats = dict(
            steps=steps_taken,
            episodes=len(episodes),
            duration=duration,
            steps_per_sec=steps_taken / max(duration, 1e-9),
            mean_return=(float(np.mean(self.episode_returns[-20:]))
                         if self.episode_returns else 0.0),
        )
        # search telemetry: mean entropy of the root visit distribution and
        # mean searched root value of the last chunk
        vc = np.asarray(records["visit_counts"], np.float64)
        p = vc / np.maximum(vc.sum(-1, keepdims=True), 1e-9)
        stats["visit_entropy"] = float(np.mean(-np.sum(p * np.log(np.maximum(p, 1e-12)), axis=-1)))
        stats["searched_value"] = float(np.mean(records["searched_value"]))
        stats.update({k: float(np.mean(records[k])) for k in _TELEMETRY_KEYS if k in records})
        return episodes, priorities, stats
