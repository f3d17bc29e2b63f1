"""Atari (ALE) host env with the DeepMind preprocessing
(``lightzero_tpu/envs/atari.py``), gated on ALE: a noop reset of up to
``noop_max`` no-ops, a frame skip of 4 with the last two frames max-pooled,
a bilinear resize to ``size`` x ``size`` in numpy, rewards clipped to
[-1, 1], a life loss ending the episode, and RGB frames channel-last in
[0, 1] (the buffer stacks frames, ``frame_stack_num``). ``AtariVecEnv`` has
the ``HostVecEnv`` interface (``envs/host_env.py``); env ``i`` draws its
no-ops from ``RandomState(seed + i)``.

Without ALE's gymnasium ids, ``is_available()`` is False and building an
env raises ``ImportError``.
"""
from __future__ import annotations

import numpy as np

from lightzero_tpu_torch.envs.host_env import no_player


def is_available() -> bool:
    try:
        import gymnasium

        gymnasium.spec("ALE/Pong-v5")
        return True
    except Exception:
        return False


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize (H, W, C) -> (out_h, out_w, C) in float32, the
    corners kept on the corners."""
    h, w = img.shape[:2]
    ys = np.linspace(0, h - 1, out_h)
    xs = np.linspace(0, w - 1, out_w)
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


class AtariEnv:
    """One ALE env with the DeepMind preprocessing."""

    def __init__(
        self,
        env_id: str = "ALE/Pong-v5",
        frame_skip: int = 4,
        noop_max: int = 30,
        size: int = 96,
        gray: bool = False,
        clip_rewards: bool = True,
        episode_life: bool = True,
        max_episode_steps: int = 108_000,
        seed: int = 0,
    ):
        if not is_available():
            raise ImportError(
                "ale_py (ALE's gymnasium ids) is not installed; AtariEnv is a gated adapter "
                "(the Atari configs load but cannot run)"
            )
        import gymnasium

        self._env = gymnasium.make(env_id, frameskip=1, repeat_action_probability=0.0)
        self.frame_skip = frame_skip
        self.noop_max = noop_max
        self.size = size
        self.gray = gray
        self.clip_rewards = clip_rewards
        self.episode_life = episode_life
        self.max_episode_steps = max_episode_steps
        self.action_space_size = int(self._env.action_space.n)
        self.observation_shape = (size, size, 1 if gray else 3)
        self._rng = np.random.RandomState(seed)
        self._lives = 0
        self._t = 0

    def _obs(self, frame: np.ndarray) -> np.ndarray:
        if self.gray:
            frame = frame.mean(-1, keepdims=True)
        return (_resize_bilinear(frame, self.size, self.size) / 255.0).astype(np.float32)

    def _lives_left(self) -> int:
        return self._env.unwrapped.ale.lives() if hasattr(self._env.unwrapped, "ale") else 0

    def reset(self) -> np.ndarray:
        frame, _ = self._env.reset()
        for _ in range(self._rng.randint(0, self.noop_max + 1)):
            frame, _, terminated, truncated, _ = self._env.step(0)
            if terminated or truncated:
                frame, _ = self._env.reset()
        self._lives = self._lives_left()
        self._t = 0
        return self._obs(frame)

    def step(self, action: int):
        """(obs, clipped reward, done, raw reward)"""
        total_reward = 0.0
        frames = []
        terminated = truncated = False
        for i in range(self.frame_skip):
            frame, r, terminated, truncated, _ = self._env.step(int(action))
            total_reward += float(r)
            if i >= self.frame_skip - 2:
                frames.append(frame)
            if terminated or truncated:
                break
        obs_frame = np.max(np.stack(frames), axis=0) if len(frames) > 1 else frames[-1]
        self._t += 1
        done = terminated or truncated or self._t >= self.max_episode_steps
        if self.episode_life and hasattr(self._env.unwrapped, "ale"):
            lives = self._env.unwrapped.ale.lives()
            if 0 < lives < self._lives:
                done = True
            self._lives = lives
        reward = float(np.clip(total_reward, -1, 1)) if self.clip_rewards else total_reward
        return self._obs(obs_frame), reward, done, total_reward


class AtariVecEnv:
    def __init__(self, env_id: str, num_envs: int, seed: int = 0, env_kwargs=None):
        kwargs = dict(env_kwargs or {})
        self.num_envs = num_envs
        self._envs = [AtariEnv(env_id, seed=seed + i, **kwargs) for i in range(num_envs)]
        self.action_space_size = self._envs[0].action_space_size
        self.observation_shape = self._envs[0].observation_shape
        self.continuous = False

    def _legal(self) -> np.ndarray:
        return np.ones((self.num_envs, self.action_space_size), bool)

    def reset_all(self):
        return np.stack([e.reset() for e in self._envs]), self._legal(), no_player(self.num_envs)

    def step(self, actions):
        obs, rewards, dones = [], [], []
        for env, a in zip(self._envs, actions):
            o, r, done, _ = env.step(int(a))
            if done:
                o = env.reset()
            obs.append(o)
            rewards.append(r)
            dones.append(done)
        return (np.stack(obs), np.asarray(rewards, np.float32), np.asarray(dones, bool),
                self._legal(), no_player(self.num_envs))
