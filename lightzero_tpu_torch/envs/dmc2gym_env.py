"""DeepMind Control suite host env (``lightzero_tpu/envs/dmc2gym_env.py``),
gated on ``dm_control``: a (domain, task) pair of the suite with its
observations flattened to float32 in the order of the suite's observation
dict, or rendered (height, width, 3) frames with ``from_pixels``, and
continuous actions in [-1, 1] mapped onto the action spec's bounds. Env
``i`` is loaded with ``random=seed + i``; each step repeats the action
``frame_skip`` times (stopping at the episode's end) and sums the rewards.
The ``HostVecEnv`` interface (``envs/host_env.py``).

Without dm_control, building the env raises ``ImportError`` and
``is_available()`` is False.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from lightzero_tpu_torch.envs.host_env import no_player, to_action_bounds


def is_available() -> bool:
    try:
        from dm_control import suite  # noqa: F401

        return True
    except Exception:
        return False


def _flatten_obs(obs_dict) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float32).ravel() for v in obs_dict.values()])


class DMC2GymVecEnv:
    def __init__(
        self,
        domain_name: str = "cartpole",
        task_name: str = "swingup",
        num_envs: int = 1,
        seed: int = 0,
        from_pixels: bool = False,
        height: int = 84,
        width: int = 84,
        frame_skip: int = 2,
    ):
        if not is_available():
            raise ImportError(
                "dm_control is not installed; DMC2GymVecEnv is a gated adapter "
                "(the dmc2gym configs load but cannot run)"
            )
        from dm_control import suite

        self.num_envs = num_envs
        self.from_pixels = from_pixels
        self.height, self.width = height, width
        self.frame_skip = frame_skip
        self._envs = [suite.load(domain_name, task_name, task_kwargs={"random": seed + i})
                      for i in range(num_envs)]
        spec = self._envs[0].action_spec()
        self.action_space_size = int(np.prod(spec.shape))
        self.continuous = True
        self._low = np.asarray(spec.minimum, np.float32)
        self._high = np.asarray(spec.maximum, np.float32)
        # the first env is reset once here, as in the JAX adapter, so that
        # its seeded episodes are the same in both packages
        ts = self._envs[0].reset()
        self.observation_shape = ((height, width, 3) if from_pixels
                                  else int(_flatten_obs(ts.observation).shape[0]))

    def _obs(self, i: int, ts) -> np.ndarray:
        if self.from_pixels:
            return np.asarray(self._envs[i].physics.render(self.height, self.width, camera_id=0),
                              np.float32)
        return _flatten_obs(ts.observation)

    def _legal(self) -> np.ndarray:
        return np.ones((self.num_envs, self.action_space_size), bool)

    def reset_all(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        obs = np.stack([self._obs(i, e.reset()) for i, e in enumerate(self._envs)])
        return obs, self._legal(), no_player(self.num_envs)

    def step(self, actions: np.ndarray):
        obs, rewards, dones = [], [], []
        for i, env in enumerate(self._envs):
            a = to_action_bounds(actions[i], self._low, self._high)
            reward, ts = 0.0, None
            for _ in range(self.frame_skip):
                ts = env.step(a)
                reward += float(ts.reward or 0.0)
                if ts.last():
                    break
            done = bool(ts.last())
            if done:
                ts = env.reset()
            obs.append(self._obs(i, ts))
            rewards.append(reward)
            dones.append(done)
        return (np.stack(obs), np.asarray(rewards, np.float32), np.asarray(dones, bool),
                self._legal(), no_player(self.num_envs))
