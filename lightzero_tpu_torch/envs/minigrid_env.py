"""MiniGrid host env (``lightzero_tpu/envs/minigrid_env.py``), gated on the
``minigrid`` package: a MiniGrid task through ``gymnasium.make``, a narrower
field of view for the AKTDT memory variants (``ViewSizeWrapper``), the
observation flattened by ``FlatObsWrapper`` into a (2835,) float vector,
every one of the 7 actions legal, one player. An episode ends at the task's
end or after ``max_step`` steps. Env ``i`` is reset with seed ``seed + i``,
plus 10,000 at each reset. The ``HostVecEnv`` interface
(``envs/host_env.py``).

Without minigrid, ``is_available()`` is False and building the env raises
``ImportError``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from lightzero_tpu_torch.envs.host_env import no_player


def is_available() -> bool:
    try:
        import gymnasium  # noqa: F401
        import minigrid  # noqa: F401

        return True
    except Exception:
        return False


class MiniGridVecEnv:
    # the AKTDT memory variants narrow the agent's field of view
    # (minigrid_lightzero_env.py:91-96 of the reference)
    _VIEW_SIZE = {
        "MiniGrid-AKTDT-13x13-v0": 5,
        "MiniGrid-AKTDT-13x13-1-v0": 5,
        "MiniGrid-AKTDT-7x7-1-v0": 3,
    }

    def __init__(
        self,
        env_id: str = "MiniGrid-Empty-8x8-v0",
        num_envs: int = 1,
        seed: int = 0,
        max_step: int = 300,
        flat_obs: bool = True,
    ):
        if not is_available():
            raise ImportError(
                "minigrid is not installed; MiniGridVecEnv is a gated adapter "
                "(the minigrid configs load but cannot run)"
            )
        import gymnasium as gym
        from minigrid.wrappers import FlatObsWrapper, ViewSizeWrapper

        self.env_id = env_id
        self.num_envs = num_envs
        self.max_step = max_step
        self._envs = []
        for _ in range(num_envs):
            e = gym.make(env_id)
            e.unwrapped.max_steps = max_step
            if env_id in self._VIEW_SIZE:
                e = ViewSizeWrapper(e, agent_view_size=self._VIEW_SIZE[env_id])
            if flat_obs:
                e = FlatObsWrapper(e)
            self._envs.append(e)
        self._seeds = [seed + i for i in range(num_envs)]
        self._steps = np.zeros(num_envs, np.int64)
        self.action_space_size = int(self._envs[0].action_space.n)
        shape = self._envs[0].observation_space.shape
        self.observation_shape = int(shape[0]) if len(shape) == 1 else tuple(shape)
        self.continuous = False

    def _legal(self) -> np.ndarray:
        return np.ones((self.num_envs, self.action_space_size), bool)

    def _reset_one(self, i: int) -> np.ndarray:
        obs, _ = self._envs[i].reset(seed=self._seeds[i])
        self._seeds[i] += 10_000
        self._steps[i] = 0
        return np.asarray(obs, np.float32)

    def reset_all(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        obs = np.stack([self._reset_one(i) for i in range(self.num_envs)])
        return obs, self._legal(), no_player(self.num_envs)

    def step(self, actions: np.ndarray):
        obs, rewards, dones = [], [], []
        for i, env in enumerate(self._envs):
            o, r, terminated, truncated, _ = env.step(int(actions[i]))
            self._steps[i] += 1
            done = bool(terminated or truncated or self._steps[i] >= self.max_step)
            if done:
                o = self._reset_one(i)
            obs.append(np.asarray(o, np.float32))
            rewards.append(float(r))
            dones.append(done)
        return (np.stack(obs), np.asarray(rewards, np.float32), np.asarray(dones, bool),
                self._legal(), no_player(self.num_envs))
