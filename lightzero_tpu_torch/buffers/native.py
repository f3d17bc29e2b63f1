"""ctypes binding of the native replay core (``csrc/replay_core.cpp``), the
counterpart of ``lightzero_tpu/buffers/native/__init__.py``.

The library is built with g++ at first use, and its two entry points'
types declared, by ``_build.py``. Where the JAX loader answers
``available() == False`` when the build fails and its buffer quietly takes
the Python path, this one raises ``BuildError``: the Python path is chosen
only by ``use_native_replay=False``.
"""
from __future__ import annotations

import numpy as np

from lightzero_tpu_torch import _build


def library():
    """The replay core, built and bound on first use."""
    return _build.load("replay_core")


def sample_prioritized(priorities: np.ndarray, alpha: float, beta: float, batch: int, seed: int):
    """``batch`` indices drawn with probability p_i^alpha / sum, and their
    max-normalized importance weights (n P(i))^-beta."""
    priorities = np.ascontiguousarray(priorities, np.float64)
    if priorities.ndim != 1 or len(priorities) == 0:
        raise ValueError(f"priorities must be a non-empty vector, got shape {priorities.shape}")
    idx = np.empty(batch, np.int64)
    w = np.empty(batch, np.float32)
    _build.entry("sample_prioritized")(
        priorities, len(priorities), alpha, beta, batch, seed & 0xFFFFFFFFFFFFFFFF, idx, w
    )
    return idx, w


def assemble_unroll(ep_start, ep_len, pos, truncated, flat_rewards, K: int, td: int, gamma: float):
    """Gather indices, masks, n-step reward sums and bootstrap positions for
    a batch of sampled (episode, position) pairs (see replay_core.cpp)."""
    B = len(pos)
    ep_start = np.ascontiguousarray(ep_start, np.int64)
    ep_len = np.ascontiguousarray(ep_len, np.int64)
    pos = np.ascontiguousarray(pos, np.int64)
    truncated = np.ascontiguousarray(truncated, np.uint8)
    flat_rewards = np.ascontiguousarray(flat_rewards, np.float32)
    if not (len(ep_start) == len(ep_len) == len(truncated) == B):
        raise ValueError("ep_start, ep_len, pos and truncated must have one entry per sample")
    if B and (np.any(pos < 0) or np.any(pos >= ep_len)
              or np.any(ep_start + ep_len > len(flat_rewards))):
        raise ValueError("a sampled position lies outside its episode or the reward pool")
    out = dict(
        obs_idx=np.empty((B, K + 1), np.int64),
        obs_valid=np.empty((B, K + 1), np.uint8),
        action_idx=np.empty((B, K), np.int64),
        action_pad=np.empty((B, K), np.uint8),
        mask=np.empty((B, K), np.float32),
        reward_sum=np.empty((B, K + 1), np.float32),
        boot_idx=np.empty((B, K + 1), np.int64),
        boot_valid=np.empty((B, K + 1), np.uint8),
        boot_disc=np.empty((B, K + 1), np.float32),
    )
    _build.entry("assemble_unroll")(
        ep_start, ep_len, pos, truncated, flat_rewards, B, K, td, gamma,
        out["obs_idx"], out["obs_valid"], out["action_idx"], out["action_pad"], out["mask"],
        out["reward_sum"], out["boot_idx"], out["boot_valid"], out["boot_disc"],
    )
    return out
