"""Board-game symmetry augmentation of AlphaZero's self-play samples
(``lightzero_tpu/ops/board_augment.py``, the reference's
``get_augmented_data``, lzero/mcts/utils.py:45): each (obs planes,
visit-count policy, winner z) sample becomes its symmetry orbit. Square
boards whose actions are the cells (TicTacToe, Gomoku, Go; a trailing pass
action stays where it is) take the 8 dihedral transforms (4 rotations, each
with and without the left-right mirror); column games (Connect4) the
identity and the mirror. Numpy on the host, once per collected sample, as in
the JAX package.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class AugmentedSample(NamedTuple):
    obs: np.ndarray
    probs: np.ndarray
    z: float


def _transform_planes(obs: np.ndarray, k: int, mirror: bool) -> np.ndarray:
    """obs (H, W, C) rotated by 90 degrees k times, then mirrored left-right."""
    out = np.rot90(obs, k, axes=(0, 1))
    if mirror:
        out = out[:, ::-1]
    return np.ascontiguousarray(out)


def _transform_grid_probs(probs: np.ndarray, h: int, w: int, k: int, mirror: bool,
                          has_pass: bool) -> np.ndarray:
    body = _transform_planes(probs[:h * w].reshape(h, w), k, mirror).reshape(-1)
    if has_pass:
        body = np.concatenate([body, probs[h * w:]])
    return np.ascontiguousarray(body.astype(probs.dtype))


def get_augmented_data(obs: np.ndarray, probs: np.ndarray, z: float) -> List[AugmentedSample]:
    """The symmetry orbit of one (obs (H, W, C), probs (A,), z) sample: A is
    H * W (cells), H * W + 1 (cells and pass) or W (columns); any other
    layout gives the sample alone."""
    h, w = int(obs.shape[0]), int(obs.shape[1])
    a = int(probs.shape[0])
    if h == w and a in (h * w, h * w + 1):
        has_pass = a == h * w + 1
        return [AugmentedSample(_transform_planes(obs, k, mirror),
                                _transform_grid_probs(probs, h, w, k, mirror, has_pass), z)
                for mirror in (False, True) for k in range(4)]
    if a == w:
        return [AugmentedSample(np.ascontiguousarray(obs), probs, z),
                AugmentedSample(np.ascontiguousarray(obs[:, ::-1]),
                                np.ascontiguousarray(probs[::-1]), z)]
    return [AugmentedSample(np.ascontiguousarray(obs), probs, z)]
