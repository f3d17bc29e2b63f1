"""The fused pUCT descent: the port's plain version
(lightzero_tpu_torch/search/fused_traverse.py:fused_traverse_reference)
against the TPU kernel lightzero_tpu/search/pallas_traverse.py run in
interpret mode, as tests/test_pallas_traverse.py runs it, on the same packed
tables and the same noise_u. The tables are valid random trees with illegal
actions, terminal children, exact score ties and deep chains.

Path, action, depth, leaf, parent and the leaf flag must be exactly equal;
the recorded stats allclose to 1e-6 (they are copies, so in practice equal).
The shapes include A values the CUDA kernel's lane mapping has to handle
(one action a lane, A=18, and more actions than lanes, A=37). The CUDA
kernel is held against the plain version on the card by chip_smoke.py
(it cannot run here: no nvcc, no GPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.search.pallas_traverse import pallas_traverse
from lightzero_tpu_torch.search.fused_traverse import (
    SYNTHETIC_SEED,
    SYNTHETIC_SHAPES,
    check_inputs,
    fused_traverse_reference,
)

pytestmark = pytest.mark.unittest

# (B, A, N): CartPole, bench-like A, odd A, the Atari action set, more
# actions than a warp has lanes
SHAPES = [(8, 2, 26), (6, 4, 13), (4, 5, 9), (4, 18, 20), (3, 37, 12)]


def _kwargs(A, N, first):
    return dict(
        A=A, N=N, max_depth=N + 1, discount=0.997, pb_c_base=19652.0, pb_c_init=1.25,
        value_delta_max=0.01, tie_break_first=first, tie_break_epsilon=1e-6,
    )


def _torch_inputs(d):
    return [None if d[k] is None else torch.from_numpy(d[k])
            for k in ("packed", "vmin", "vmax", "root_stats", "noise_u")]


@pytest.mark.parametrize("B,A,N", SHAPES)
@pytest.mark.parametrize("tie_break", ["first", "noise"])
def test_reference_matches_pallas_kernel(B, A, N, tie_break):
    first = tie_break == "first"
    d = check_inputs(np.random.default_rng(B * 100 + A), B, A, N, with_noise=not first)
    kw = _kwargs(A, N, first)
    exp = pallas_traverse(
        *(None if d[k] is None else jnp.asarray(d[k])
          for k in ("packed", "vmin", "vmax", "root_stats", "noise_u")),
        interpret=True, **kw,
    )
    exp = [np.asarray(x) for x in exp]
    got = [x.numpy() for x in fused_traverse_reference(*_torch_inputs(d), **kw)]
    # scalars: node, parent, last action, depth, leaf flag
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1], err_msg="path")
    np.testing.assert_array_equal(got[2], exp[2], err_msg="path action")
    for name, g, e in zip(("reward", "value_sum", "visit"), got[3:], exp[3:]):
        np.testing.assert_allclose(g, e, rtol=1e-6, atol=1e-6, err_msg=name)
    assert exp[0][:, 3].max() >= N // 3, "no deep descent among the cases"


def test_tables_exercise_terminal_stops_and_ties():
    B, A, N = 32, 4, 51
    d = check_inputs(np.random.default_rng(7), B, A, N, with_noise=True)
    out_first = fused_traverse_reference(*_torch_inputs(d), **_kwargs(A, N, True))
    out_noise = fused_traverse_reference(*_torch_inputs(d), **_kwargs(A, N, False))
    assert out_first[0][:, 4].sum() > 0, "no descent stopped at a terminal child"
    # exact ties among unvisited children are decided by the noise table
    assert not torch.equal(out_first[0][:, 2], out_noise[0][:, 2])


@pytest.mark.parametrize("case", [i for i, (B, _, _) in enumerate(SYNTHETIC_SHAPES) if B >= 64])
def test_phase3_noise_tables_vary_after_the_stop(case):
    """Under 'noise', the columns after a tree stops take their actions from
    each column's own noise_u row. chip_smoke.py's phase-3 tables must hold
    trees whose columns after the stop carry different actions, so that a
    kernel whose tail fill ignored noise_u[t] would disagree on the card."""
    B, A, N = SYNTHETIC_SHAPES[case]
    d = check_inputs(np.random.default_rng(SYNTHETIC_SEED + case), B, A, N, with_noise=True)
    scal, _, paction, *_ = fused_traverse_reference(*_torch_inputs(d), **_kwargs(A, N, False))
    # the last active column is t_stop + 1: depth counts the moves, and a
    # stop on a terminal child moved into it
    t_stop = (scal[:, 3] - scal[:, 4]).long()
    col = torch.arange(N + 1)[None, :]
    tail = col >= t_stop[:, None] + 2
    lo = torch.where(tail, paction, torch.inf).amin(dim=1)
    hi = torch.where(tail, paction, -torch.inf).amax(dim=1)
    assert int((hi > lo).sum()) > 0, "no tree's tail columns carry different actions"
