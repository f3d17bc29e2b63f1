"""Host-side batched env over gymnasium (``lightzero_tpu/envs/host_env.py``)
for the envs that are not tensor envs: Box2D, MuJoCo, MountainCar and the
other gymnasium ids. The envs step one by one in this process, in numpy; the
policy's search runs batched on its device (``workers/host_collector.py``).

Env ``i`` is reset with seed ``seed + i``, and each reset adds 10,000 to its
seed, so two runs on the same seed see the same episodes. Continuous actions
come in [-1, 1] and are mapped onto the action box's bounds. Observations
are float32; ``observation_shape`` is an int for flat observations and a
tuple otherwise. gymnasium is imported when an env is built: without it,
building one raises ``ImportError``.

The interface every host adapter has (``HostVecEnv``, ``DMC2GymVecEnv``,
the gated adapters): ``num_envs``, ``action_space_size``,
``observation_shape``, ``continuous``; ``reset_all() -> (obs, legal,
to_play)`` and ``step(actions) -> (obs, rewards, dones, legal, to_play)``,
numpy arrays with the batch first, each env reset within ``step`` when its
episode ends (``dones`` flags it: terminated or truncated).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def to_action_bounds(action, low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """A normalised action in [-1, 1] (clipped to it) mapped onto [low, high]."""
    return low + (np.clip(np.asarray(action, np.float32), -1, 1) + 1) * 0.5 * (high - low)


def no_player(num_envs: int) -> np.ndarray:
    """(B,) -1: the host envs have one player."""
    return np.full((num_envs,), -1, np.int64)


class HostVecEnv:
    def __init__(self, env_id: str, num_envs: int, seed: int = 0,
                 env_kwargs: Optional[dict] = None):
        import gymnasium
        import gymnasium.spaces as spaces

        self.env_id = env_id
        self.num_envs = num_envs
        self._envs = [gymnasium.make(env_id, **(env_kwargs or {})) for _ in range(num_envs)]
        self._seeds = [seed + i for i in range(num_envs)]
        space = self._envs[0].action_space
        if isinstance(space, spaces.Discrete):
            self.action_space_size = int(space.n)
            self.continuous = False
        else:
            self.action_space_size = int(np.prod(space.shape))
            self.continuous = True
            self._low = np.asarray(space.low, np.float32)
            self._high = np.asarray(space.high, np.float32)
        shape = self._envs[0].observation_space.shape
        self.observation_shape = tuple(shape) if len(shape) > 1 else int(shape[0])

    def _legal(self) -> np.ndarray:
        return np.ones((self.num_envs, max(self.action_space_size, 1)), bool)

    def _reset_one(self, i: int):
        obs, _ = self._envs[i].reset(seed=self._seeds[i])
        self._seeds[i] += 10_000
        return obs

    def reset_all(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        obs = [self._reset_one(i) for i in range(self.num_envs)]
        return np.asarray(obs, np.float32), self._legal(), no_player(self.num_envs)

    def step(self, actions: np.ndarray):
        obs, rewards, dones = [], [], []
        for i, env in enumerate(self._envs):
            a = (to_action_bounds(actions[i], self._low, self._high) if self.continuous
                 else int(actions[i]))
            o, r, terminated, truncated, _ = env.step(a)
            done = bool(terminated or truncated)
            if done:
                o = self._reset_one(i)
            obs.append(o)
            rewards.append(r)
            dones.append(done)
        return (np.asarray(obs, np.float32), np.asarray(rewards, np.float32),
                np.asarray(dones, bool), self._legal(), no_player(self.num_envs))
