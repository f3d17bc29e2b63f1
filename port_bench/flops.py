"""Operations and bytes the benchmark's work needs, from shapes alone.

FLOPs count the convolutions and matrix products (a multiply-add is 2), as
``torch.utils.flop_counter.FlopCounterMode`` counts them, and nothing else:
norms, activations, softmaxes and the search's bookkeeping are left out, so
a share of the peak built on them is a lower bound of the work done.

The descent kernel's bytes and operations are ``chip_smoke.py``
``traverse_case``'s (copied from there): what the trees' depths need, each
row the descent visits read once, against HBM bandwidth and the float32
peak.
"""
from __future__ import annotations

from typing import Sequence

# operations the descent does per tree and level (log, sqrt, the mean-Q
# divisions) and per action and level (child value, pUCT score,
# normalisation, clip, argmax; a second scoring pass for the noise
# tie-break), keyed by whether the tie-break is 'first' (copied from
# chip_smoke.py)
OPS_PER_LEVEL = 16
OPS_PER_ACTION = {True: 30, False: 52}


def conv(h: int, w: int, c_in: int, c_out: int, k: int) -> float:
    """A k x k convolution producing an h x w x c_out map."""
    return 2.0 * h * w * c_out * c_in * k * k


def linear(n_in: int, n_out: int) -> float:
    return 2.0 * n_in * n_out


def ceil_half(n: int) -> int:
    return -(-n // 2)


def downsample(h: int, w: int, c_in: int, c: int) -> float:
    """The Atari pyramid with one res block a stage (96x96 -> 6x6, 64x64 -> 4x4)."""
    h1, w1 = ceil_half(h), ceil_half(w)
    h2, w2 = ceil_half(h1), ceil_half(w1)
    h3, w3 = h2 // 2, w2 // 2
    return (conv(h1, w1, c_in, c // 2, 3) + 2 * conv(h1, w1, c // 2, c // 2, 3)
            + conv(h2, w2, c // 2, c, 3) + 2 * conv(h2, w2, c, c, 3)
            + 2 * conv(h3, w3, c, c, 3))


def latent_hw(obs_shape: Sequence[int]) -> tuple:
    h, w = (ceil_half(ceil_half(int(n))) // 2 // 2 for n in obs_shape[:2])
    return h, w


def res_blocks(h: int, w: int, c: int, n: int) -> float:
    return n * 2 * conv(h, w, c, c, 3)


def conv_head(h: int, w: int, c: int, head_c: int, hidden: int, out: int) -> float:
    """conv1x1 to head_c channels, then the MLP of one hidden layer."""
    return conv(h, w, c, head_c, 1) + linear(h * w * head_c, hidden) + linear(hidden, out)


def descent_bytes_ops(depth_sum: float, trees: int, A: int, N: int, first: bool) -> tuple:
    """(bytes, operations) of one launch of the descent over ``trees`` trees
    whose depths sum to ``depth_sum``: the depth + 1 rows each descent
    visits, the per-tree inputs, the noise table, the outputs."""
    D = N + 1
    C = 7 * A + 2
    nbytes = 4 * ((depth_sum + trees) * C + trees * (1 + 1 + 4)
                  + (0 if first else (D - 1) * trees * A) + trees * (8 + 5 * D))
    ops = (depth_sum + 2 * trees) * (OPS_PER_LEVEL + OPS_PER_ACTION[first] * A)
    return nbytes, ops
