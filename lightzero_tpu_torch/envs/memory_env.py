"""The cue-recall memory env (``lightzero_tpu/envs/memory_env.py``) as a
batched tensor env.

Step 0 shows a cue, one of ``num_cues``; steps 1 .. ``memory_length`` show
nothing and ignore the action; at the last step the action must name the cue:
reward +1 if it does, -1 if not, and the episode ends (``memory_length`` + 2
steps). Observation (3 + ``num_cues`` + 1): the phase one-hot (cue, memory,
query), the cue one-hot (only in the cue phase), and t / (``memory_length``
+ 2).

The env resets itself where an episode ends. The one random draw, the cue of
a fresh episode (``draw_reset``), is kept apart from the deterministic
transition (``transition``), so that a caller can hand in draws made
elsewhere, as the tests hand in the JAX env's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv


class MemoryState(NamedTuple):
    cue: torch.Tensor  # (B,) int32
    t: torch.Tensor  # (B,) int32 step of the episode (0 = cue phase)


class MemoryEnv(TensorEnv):
    num_players = 1

    def __init__(self, num_cues: int = 4, memory_length: int = 10):
        self.num_cues = num_cues
        self.memory_length = memory_length
        self.action_space_size = num_cues
        self.observation_shape = 3 + num_cues + 1
        self._episode_len = memory_length + 2

    def observe(self, s: MemoryState) -> torch.Tensor:
        phase = torch.where(s.t == 0, 0, torch.where(s.t <= self.memory_length, 1, 2)).long()
        phase_oh = torch.nn.functional.one_hot(phase, 3).to(torch.float32)
        cue_oh = torch.nn.functional.one_hot(s.cue.long(), self.num_cues).to(torch.float32)
        cue_vis = cue_oh * (phase == 0).to(torch.float32)[:, None]
        # a product by the float32 reciprocal, as XLA computes the JAX env's t / T
        t = (s.t.to(torch.float32) * (1.0 / self._episode_len))[:, None]
        return torch.cat([phase_oh, cue_vis, t], dim=1)

    def draw_reset(self, num_envs: int, generator: torch.Generator) -> torch.Tensor:
        """(B,) int32 cues of fresh episodes, uniform."""
        return torch.randint(0, self.num_cues, (num_envs,), generator=generator,
                             device=generator.device, dtype=torch.int32)

    @staticmethod
    def initial_state(cue: torch.Tensor) -> MemoryState:
        return MemoryState(cue=cue.to(torch.int32), t=torch.zeros_like(cue, dtype=torch.int32))

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[MemoryState, torch.Tensor]:
        s = self.initial_state(self.draw_reset(num_envs, generator))
        return s, self.observe(s)

    def legal_mask(self, state: MemoryState) -> torch.Tensor:
        return torch.ones((state.t.shape[0], self.num_cues), dtype=torch.bool,
                          device=state.t.device)

    def transition(self, state: MemoryState, action: torch.Tensor, reset_cue: torch.Tensor
                   ) -> EnvStep:
        """One step for every env; where the episode ends the next one shows
        ``reset_cue``."""
        done = state.t == self.memory_length + 1
        right = action.to(state.cue.device).to(torch.int32) == state.cue
        reward = torch.where(done, torch.where(right, 1.0, -1.0), 0.0)
        ns = MemoryState(cue=state.cue, t=state.t + 1)
        fresh = self.initial_state(reset_cue)
        out = MemoryState(*(torch.where(done, r, n) for r, n in zip(fresh, ns)))
        B = done.shape[0]
        return EnvStep(
            state=out,
            obs=self.observe(out),
            reward=reward.to(torch.float32),
            done=done,
            legal_mask=self.legal_mask(out),
            to_play=torch.full((B,), -1, dtype=torch.int32, device=done.device),
            truncated=torch.zeros_like(done),
        )

    def step(self, state: MemoryState, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        return self.transition(state, action, self.draw_reset(action.shape[0], generator))
