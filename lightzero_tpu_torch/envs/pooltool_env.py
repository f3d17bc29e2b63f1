"""Pooltool billiards "sum to three" host env
(``lightzero_tpu/envs/pooltool_env.py``), gated on ``pooltool``: the agent
strikes the cue ball with a continuous (speed V0, cut angle) action in
[-1, 1], mapped onto V0 in [0.3, 3] and the angle in [-70, 70] degrees; the
reward is 1 when the ball-ball and ball-cushion collisions of the shot sum
to three. The observation is the (x, y) of both balls; an episode lasts
``episode_length`` shots. The ``HostVecEnv`` interface
(``envs/host_env.py``).

Without pooltool, ``is_available()`` is False and building the env raises
``ImportError``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from lightzero_tpu_torch.envs.host_env import no_player


def is_available() -> bool:
    try:
        import pooltool  # noqa: F401

        return True
    except Exception:
        return False


# the action bounds of the reference config (V0 in [0.3, 3], the cut angle
# in [-70, 70] degrees)
V0_BOUNDS = (0.3, 3.0)
ANGLE_BOUNDS = (-70.0, 70.0)


class SumToThreeVecEnv:
    def __init__(self, num_envs: int = 1, seed: int = 0, episode_length: int = 10):
        if not is_available():
            raise ImportError(
                "pooltool is not installed; SumToThreeVecEnv is a gated adapter "
                "(the pooltool configs load but cannot run)"
            )
        import pooltool as pt

        self._pt = pt
        self.num_envs = num_envs
        self.episode_length = episode_length
        self.action_space_size = 2  # (V0, cut angle)
        self.continuous = True
        self.observation_shape = 4  # cue (x, y) and object (x, y)
        self._rng = np.random.RandomState(seed)
        self._systems = [self._new_system() for _ in range(num_envs)]
        self._steps = np.zeros(num_envs, np.int64)

    def _new_system(self):
        pt = self._pt
        table = pt.Table.default()
        balls = {
            "cue": pt.Ball.create("cue", xy=(table.w * 0.5, table.l * 0.25)),
            "object": pt.Ball.create("object", xy=(table.w * 0.5, table.l * 0.75)),
        }
        return pt.System(table=table, balls=balls, cue=pt.Cue(cue_ball_id="cue"))

    def _obs_one(self, i: int) -> np.ndarray:
        s = self._systems[i]
        c = s.balls["cue"].state.rvw[0]
        o = s.balls["object"].state.rvw[0]
        return np.asarray([c[0], c[1], o[0], o[1]], np.float32)

    def reset_all(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        self._systems = [self._new_system() for _ in range(self.num_envs)]
        self._steps[:] = 0
        obs = np.stack([self._obs_one(i) for i in range(self.num_envs)])
        return obs, np.ones((self.num_envs, 2), bool), no_player(self.num_envs)

    def step(self, actions: np.ndarray):
        pt = self._pt
        obs, rewards, dones = [], [], []
        for i in range(self.num_envs):
            a = np.clip(np.asarray(actions[i], np.float32), -1, 1)
            V0 = V0_BOUNDS[0] + (a[0] + 1) * 0.5 * (V0_BOUNDS[1] - V0_BOUNDS[0])
            angle = ANGLE_BOUNDS[0] + (a[1] + 1) * 0.5 * (ANGLE_BOUNDS[1] - ANGLE_BOUNDS[0])
            s = self._systems[i]
            s.cue.set_state(V0=float(V0), phi=pt.aim.at_ball(s, "object", cut=float(angle)))
            pt.simulate(s, inplace=True)
            # ball-ball and ball-cushion collision events: reward 1 when 3
            n_bb = len(pt.events.filter_type(s.events, pt.EventType.BALL_BALL))
            n_bc = (len(pt.events.filter_type(s.events, pt.EventType.BALL_LINEAR_CUSHION))
                    + len(pt.events.filter_type(s.events, pt.EventType.BALL_CIRCULAR_CUSHION)))
            r = 1.0 if (n_bb + n_bc) == 3 else 0.0
            s.stop_balls()
            self._steps[i] += 1
            done = bool(self._steps[i] >= self.episode_length)
            if done:
                self._systems[i] = self._new_system()
                self._steps[i] = 0
            obs.append(self._obs_one(i))
            rewards.append(r)
            dones.append(done)
        return (np.stack(obs), np.asarray(rewards, np.float32), np.asarray(dones, bool),
                np.ones((self.num_envs, 2), bool), no_player(self.num_envs))
