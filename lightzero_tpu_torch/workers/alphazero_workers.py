"""AlphaZero's self-play collector and its evaluator against the rule bot
(``lightzero_tpu/workers/alphazero_workers.py``).

The JAX workers compile ``rollout_length`` batched steps into one
``lax.scan``; here the steps run eagerly on the policy's device and each
chunk's records go to the host once. The self-play collector keeps every
game's (obs, visit distribution, mover) until the game ends, then labels
each position with the outcome from its mover's side, z = +1 / -1, or 0 for
a draw (the final step's reward is +1 when its mover won). The evaluator
plays the deterministic agent as player 1 against the env's rule bot
(``battle_mode`` "play_with_bot_mode"): +1 a win, 0 a draw, -1 a loss.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class AZSample(NamedTuple):
    obs: np.ndarray
    probs: np.ndarray
    z: float


class AlphaZeroSelfPlayCollector:
    def __init__(self, env, policy, num_envs: int, rollout_length: int = 16, seed: int = 7):
        """The env's randomness (none in self-play) comes from a generator
        seeded with ``seed`` on the policy's device; the search's and the
        actions' from the policy's generator."""
        if env.battle_mode != "self_play_mode":
            raise ValueError("the self-play collector needs an env in self_play_mode")
        self.env = env
        self.policy = policy
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        self.generator = torch.Generator(policy.device).manual_seed(seed)
        self.total_env_steps = 0
        self.total_episodes = 0
        self._state = None
        self._pending: List[List] = [[] for _ in range(num_envs)]

    @torch.no_grad()
    def _rollout(self, temperature: float) -> Dict[str, np.ndarray]:
        records = []
        for _ in range(self.rollout_length):
            s = self._state
            out = self.policy._forward_collect(s, temperature, deterministic=False)
            step = self.env.step(s, out["action"], self.generator)
            records.append(dict(obs=out["obs"], visit_counts=out["visit_counts"],
                                mover=s.to_play, reward=step.reward, done=step.done))
            self._state = step.state
        return {k: torch.stack([r[k] for r in records]).cpu().numpy() for k in records[0]}

    def collect(self, temperature: float = 1.0, num_episodes: int = 8
                ) -> Tuple[List[AZSample], Dict]:
        """Whole chunks until ``num_episodes`` games have ended: (samples of
        the ended games, stats)."""
        t0 = time.time()
        if self._state is None:
            self._state = self.env.init_state(self.num_envs, self.policy.device)
        samples: List[AZSample] = []
        episodes = steps = 0
        while episodes < num_episodes:
            rec = self._rollout(float(temperature))
            T = self.rollout_length
            steps += T * self.num_envs
            self.total_env_steps += T * self.num_envs
            visits = rec["visit_counts"].astype(np.float64)
            probs = visits / np.maximum(visits.sum(-1, keepdims=True), 1e-9)
            for t in range(T):
                for e in range(self.num_envs):
                    mover = int(rec["mover"][t, e])
                    self._pending[e].append((rec["obs"][t, e], probs[t, e], mover))
                    if rec["done"][t, e]:
                        winner = mover if rec["reward"][t, e] > 0 else 0
                        for obs_i, probs_i, mover_i in self._pending[e]:
                            z = 0.0 if winner == 0 else (1.0 if mover_i == winner else -1.0)
                            samples.append(AZSample(obs_i, probs_i.astype(np.float32), z))
                        self._pending[e] = []
                        episodes += 1
                        self.total_episodes += 1
        duration = time.time() - t0
        return samples, dict(steps=steps, episodes=episodes, duration=duration,
                             steps_per_sec=steps / max(duration, 1e-9))


class AlphaZeroBotEvaluator:
    """The deterministic agent (player 1) against the rule bot; reports the
    mean outcome, the win and the draw rate."""

    def __init__(self, env, policy, num_envs: int = 4, rollout_length: int = 10, seed: int = 99):
        if env.battle_mode not in ("play_with_bot_mode", "eval_mode"):
            raise ValueError("the bot evaluator needs an env in play_with_bot_mode or eval_mode")
        self.env = env
        self.policy = policy
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        self.generator = torch.Generator(policy.device).manual_seed(seed)
        self.best_return = -np.inf

    @torch.no_grad()
    def eval(self, n_episodes: Optional[int] = None) -> Dict:
        """Chunks of ``rollout_length`` steps from fresh games until
        ``n_episodes`` (default: one per env) have ended."""
        t0 = time.time()
        n_episodes = n_episodes or self.num_envs
        state = self.env.init_state(self.num_envs, self.policy.device)
        outcomes: List[float] = []
        steps = 0
        while len(outcomes) < n_episodes:
            rewards, dones = [], []
            for _ in range(self.rollout_length):
                out = self.policy._forward_collect(state, 1.0, deterministic=True)
                step = self.env.step(state, out["action"], self.generator)
                rewards.append(step.reward)
                dones.append(step.done)
                state = step.state
            steps += self.rollout_length
            reward = torch.stack(rewards).cpu().numpy()
            done = torch.stack(dones).cpu().numpy()
            for t in range(self.rollout_length):
                outcomes += [float(reward[t, e]) for e in np.flatnonzero(done[t])]
        outcomes = outcomes[:n_episodes]
        mean_ret = float(np.mean(outcomes))
        new_best = mean_ret > self.best_return
        if new_best:
            self.best_return = mean_ret
        return dict(
            episode_returns=outcomes,
            mean_return=mean_ret,
            win_rate=float(np.mean([o > 0 for o in outcomes])),
            draw_rate=float(np.mean([o == 0 for o in outcomes])),
            new_best=new_best,
            env_steps=steps,
            duration=time.time() - t0,
        )
