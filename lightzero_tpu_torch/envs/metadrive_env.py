"""MetaDrive driving host env (``lightzero_tpu/envs/metadrive_env.py``),
gated on ``metadrive``: procedural driving scenarios with continuous
(steering, throttle) actions in [-1, 1], mapped onto the action box, and the
lidar and state vector as the observation. Env ``i`` starts at scenario seed
``seed + i``. The ``HostVecEnv`` interface (``envs/host_env.py``).

Without metadrive, ``is_available()`` is False and building the env raises
``ImportError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from lightzero_tpu_torch.envs.host_env import no_player, to_action_bounds


def is_available() -> bool:
    try:
        import metadrive  # noqa: F401

        return True
    except Exception:
        return False


class MetaDriveVecEnv:
    def __init__(self, num_envs: int = 1, seed: int = 0, env_config: Optional[dict] = None):
        if not is_available():
            raise ImportError(
                "metadrive is not installed; MetaDriveVecEnv is a gated adapter "
                "(the metadrive configs load but cannot run)"
            )
        from metadrive import MetaDriveEnv

        cfg = dict(use_render=False, traffic_density=0.1, start_seed=seed)
        cfg.update(env_config or {})
        self.num_envs = num_envs
        self._envs = [MetaDriveEnv(dict(cfg, start_seed=seed + i)) for i in range(num_envs)]
        space = self._envs[0].action_space
        self.action_space_size = int(np.prod(space.shape))
        self.continuous = True
        self._low = np.asarray(space.low, np.float32)
        self._high = np.asarray(space.high, np.float32)
        self.observation_shape = int(np.prod(self._envs[0].observation_space.shape))

    def _legal(self) -> np.ndarray:
        return np.ones((self.num_envs, self.action_space_size), bool)

    def reset_all(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        obs = [np.asarray(e.reset()[0], np.float32).ravel() for e in self._envs]
        return np.stack(obs), self._legal(), no_player(self.num_envs)

    def step(self, actions: np.ndarray):
        obs, rewards, dones = [], [], []
        for i, env in enumerate(self._envs):
            o, r, terminated, truncated, _ = env.step(
                to_action_bounds(actions[i], self._low, self._high))
            done = bool(terminated or truncated)
            if done:
                o, _ = env.reset()
            obs.append(np.asarray(o, np.float32).ravel())
            rewards.append(float(r))
            dones.append(done)
        return (np.stack(obs), np.asarray(rewards, np.float32), np.asarray(dones, bool),
                self._legal(), no_player(self.num_envs))
