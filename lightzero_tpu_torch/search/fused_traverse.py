"""The fused pUCT descent: one simulation's whole selection pass.

``fused_traverse`` launches the hand-written Hopper kernel
``csrc/fused_traverse.cu`` for tensors on the card and takes the plain
PyTorch version ``fused_traverse_reference`` for tensors on the CPU. It
replaces ``lightzero_tpu/search/pallas_traverse.py:_traverse_kernel`` and
keeps ``pallas_traverse``'s signature (without ``interpret``) and outputs:
scalars (B, 8) = leaf node, parent, last action, depth, leaf-is-terminal,
then five batch-major (B, D) path tables (node, action, reward, pre-backup
value sum, pre-backup visit count), all f32.

The kernel's launches are counted in ``fused_traverse.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from lightzero_tpu_torch import _build

Outputs = Tuple[torch.Tensor, ...]


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from the first entry to the last, the order the
    kernel adds in (a library reduction may pair terms differently)."""
    total = x[..., 0]
    for a in range(1, x.shape[-1]):
        total = total + x[..., a]
    return total


def fused_traverse_reference(
    packed: torch.Tensor,
    vmin: torch.Tensor,
    vmax: torch.Tensor,
    root_stats: torch.Tensor,
    noise_u: Optional[torch.Tensor],
    *,
    A: int,
    N: int,
    max_depth: int,
    discount: float,
    pb_c_base: float,
    pb_c_init: float,
    value_delta_max: float,
    tie_break_first: bool,
    tie_break_epsilon: float,
) -> Outputs:
    """Plain PyTorch version of the kernel: a batched loop over depth."""
    f32 = torch.float32
    B, D = packed.shape[0], max_depth
    dev = packed.device
    packed = packed.to(f32)
    vmin = vmin.to(f32)[:, None]
    vmax = vmax.to(f32)[:, None]
    bidx = torch.arange(B, device=dev)

    path = torch.zeros((B, D), dtype=f32, device=dev)
    paction = torch.zeros((B, D), dtype=f32, device=dev)
    preward = torch.zeros((B, D), dtype=f32, device=dev)
    pvsum = torch.zeros((B, D), dtype=f32, device=dev)
    pvisit = torch.zeros((B, D), dtype=f32, device=dev)
    preward[:, 0] = root_stats[:, 0]
    pvsum[:, 0] = root_stats[:, 1]
    pvisit[:, 0] = root_stats[:, 2]

    def normalize(q):
        delta = vmax - vmin
        denom = torch.clamp(delta, min=value_delta_max)
        return torch.where(delta > 0, (q - vmin) / denom, q)

    node = torch.zeros(B, dtype=torch.long, device=dev)
    parent = torch.zeros(B, dtype=torch.long, device=dev)
    last_action = torch.zeros(B, dtype=torch.long, device=dev)
    depth = torch.zeros(B, dtype=torch.long, device=dev)
    parent_q = torch.zeros(B, dtype=f32, device=dev)
    is_root = torch.ones(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    leaf_term = torch.zeros(B, dtype=torch.bool, device=dev)

    for t in range(D - 1):
        row = packed[bidx, node]  # (B, C)
        children = row[:, :A]
        prior = row[:, A : 2 * A]
        legal = row[:, 2 * A : 3 * A] > 0.5
        cvisit = row[:, 3 * A : 4 * A]
        cvsum = row[:, 4 * A : 5 * A]
        creward = row[:, 5 * A : 6 * A]
        cterm = row[:, 6 * A : 7 * A] > 0.5
        parent_visit = row[:, 7 * A]
        exists = children >= 0
        cvalue = torch.where(exists & (cvisit > 0), cvsum / torch.clamp(cvisit, min=1.0), 0.0)
        cvisit = torch.where(exists, cvisit, 0.0)
        creward = torch.where(exists, creward, 0.0)

        # _mean_q (ptree_mz.py:88-115)
        visited = (cvisit > 0) & legal
        q = creward + discount * cvalue
        total_q = _sum_in_order(torch.where(visited, q, 0.0))
        total_n = _sum_in_order(visited.to(f32))
        root_mean = total_q / torch.clamp(total_n, min=1.0)
        mixed = (parent_q + total_q) / (total_n + 1.0)
        mean_q = torch.where(is_root & (total_n > 0), root_mean, mixed)

        # _ucb_scores (ptree_mz.py:370-419), players == 1
        pb_c = torch.log((parent_visit + pb_c_base + 1.0) / pb_c_base) + pb_c_init
        pb_c = (pb_c * torch.sqrt(parent_visit))[:, None] / (cvisit + 1.0)
        value_score = torch.clamp(normalize(q), 0.0, 1.0)
        pq = torch.clamp(normalize(mean_q[:, None]), 0.0, 1.0)
        value_score = torch.where(cvisit > 0, value_score, pq)
        scores = torch.where(legal, pb_c * prior + value_score, -torch.inf)

        if tie_break_first:
            action = torch.argmax(scores, dim=1)
        else:
            max_s = torch.max(scores, dim=1, keepdim=True).values
            near = scores >= max_s - tie_break_epsilon
            u = noise_u[t].to(f32) if noise_u is not None else torch.zeros_like(scores)
            action = torch.argmax(torch.where(near, u, -torch.inf), dim=1)

        a1 = action[:, None]
        next_child = torch.gather(children, 1, a1)[:, 0].long()
        child_term = torch.gather(cterm, 1, a1)[:, 0]
        absent = next_child < 0
        now_done = ~done & (absent | child_term)
        move = ~done & ~absent
        new_node = torch.where(move, next_child, node)
        depth = depth + move.long()

        path[:, t + 1] = new_node.to(f32)
        paction[:, t + 1] = action.to(f32)
        preward[:, t + 1] = torch.gather(creward, 1, a1)[:, 0]
        pvsum[:, t + 1] = torch.gather(row[:, 4 * A : 5 * A], 1, a1)[:, 0]
        pvisit[:, t + 1] = torch.gather(cvisit, 1, a1)[:, 0]

        parent = torch.where(now_done & absent, node, parent)
        parent_q = torch.where(done, parent_q, mean_q)
        last_action = torch.where(done, last_action, action)
        leaf_term = torch.where(now_done, child_term, leaf_term)
        is_root = is_root & done
        done = done | now_done
        node = new_node

    scal = torch.zeros((B, 8), dtype=f32, device=dev)
    scal[:, 0] = node.to(f32)
    scal[:, 1] = parent.to(f32)
    scal[:, 2] = last_action.to(f32)
    scal[:, 3] = depth.to(f32)
    scal[:, 4] = leaf_term.to(f32)
    return scal, path, paction, preward, pvsum, pvisit


_VOID = ctypes.c_void_p
_ARGTYPES = [_VOID] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [
    ctypes.c_int,
    ctypes.c_float,
    _VOID,
]


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_traverse")
    fn = lib.fused_traverse_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def kernel_route(A: int) -> str:
    """The route the kernel takes for A actions, fixed at launch by A:
    'prefetch' (the rows of a node's children are copied on chip while the
    node is scored) or 'row read' (the next row is read after the pick).
    Builds the kernel if it is not built yet."""
    fn = _library().fused_traverse_route
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return "prefetch" if fn(A) else "row read"


def _check(name: str, x: Optional[torch.Tensor], shape: Tuple[int, ...],
           device: torch.device, dtype: torch.dtype = torch.float32) -> Optional[int]:
    """The address of a kernel's input or output once it is on ``device``
    with ``dtype`` and ``shape``, contiguous; None for an absent one."""
    if x is None:
        return None
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return x.data_ptr()


def fused_traverse(
    packed: torch.Tensor,
    vmin: torch.Tensor,
    vmax: torch.Tensor,
    root_stats: torch.Tensor,
    noise_u: Optional[torch.Tensor],
    *,
    A: int,
    N: int,
    max_depth: int,
    discount: float,
    pb_c_base: float,
    pb_c_init: float,
    value_delta_max: float,
    tie_break_first: bool,
    tie_break_epsilon: float,
) -> Outputs:
    """The descent: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Launches on the current stream without synchronising."""
    kwargs = dict(
        A=A, N=N, max_depth=max_depth, discount=discount, pb_c_base=pb_c_base,
        pb_c_init=pb_c_init, value_delta_max=value_delta_max,
        tie_break_first=tie_break_first, tie_break_epsilon=tie_break_epsilon,
    )
    if packed.device.type == "cpu":
        return fused_traverse_reference(packed, vmin, vmax, root_stats, noise_u, **kwargs)
    if packed.device.type != "cuda":
        raise ValueError(f"fused_traverse runs on cuda or cpu tensors, not {packed.device}")
    B, D = packed.shape[0], max_depth
    dev = packed.device
    _check("packed", packed, (B, N, 7 * A + 2), dev)
    _check("vmin", vmin, (B,), dev)
    _check("vmax", vmax, (B,), dev)
    _check("root_stats", root_stats, (B, 4), dev)
    _check("noise_u", noise_u, (D, B, A), dev)
    if D < 1:
        raise ValueError(f"max_depth must be at least 1, got {D}")
    lib = _library()
    scal = torch.empty((B, 8), dtype=torch.float32, device=dev)
    paths = [torch.empty((B, D), dtype=torch.float32, device=dev) for _ in range(5)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_traverse_launch(
        packed.data_ptr(), vmin.data_ptr(), vmax.data_ptr(), root_stats.data_ptr(),
        noise_u.data_ptr() if noise_u is not None else None,
        scal.data_ptr(), *(p.data_ptr() for p in paths),
        B, A, N, D,
        float(discount), float(pb_c_base), float(pb_c_init), float(value_delta_max),
        int(bool(tie_break_first)), float(tie_break_epsilon),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_traverse kernel launch failed with CUDA error {rc}")
    fused_traverse.launches += 1
    return (scal, *paths)


fused_traverse.launches = 0

# The (B, A, N) of the check_inputs tables that chip_smoke.py holds the kernel
# against its plain version on, case i from seed SYNTHETIC_SEED + i: the
# CartPole eval (3 envs, 25 sims), the CartPole batch of 8, bench.py's shape
# (B=1024, A=4, 50 sims), the Atari action set at the bench batch, and more
# actions than a warp has lanes.
SYNTHETIC_SHAPES = [(3, 2, 26), (8, 2, 26), (1024, 4, 51), (1024, 18, 51), (64, 37, 26)]
SYNTHETIC_SEED = 100


def check_inputs(
    rng: np.random.Generator, B: int, A: int, N: int, with_noise: bool
) -> dict:
    """Packed tables of valid random trees, as numpy arrays, for holding the
    kernel against its plain version (and the plain version against
    ``pallas_traverse``). Each tree has N nodes linked from the root; some
    actions are illegal, some children terminal, and the tree shape varies
    from bushy to a deep chain so that descents reach many depths."""
    C = 7 * A + 2
    packed = np.zeros((B, N, C), np.float32)
    for b in range(B):
        children = -np.ones((N, A), np.int64)
        chain = b % 3 == 0  # every third tree is a chain
        for k in range(1, N):
            while True:
                p = k - 1 if chain else int(rng.integers(0, k))
                free = np.flatnonzero(children[p] < 0)
                if free.size:
                    children[p, int(rng.choice(free))] = k
                    break
                chain = False
        visits = rng.integers(1, 40, N).astype(np.float32)
        vsum = (rng.standard_normal(N) * visits * 0.5).astype(np.float32)
        reward = rng.standard_normal(N).astype(np.float32) * 0.3
        terminal = rng.random(N) < 0.08
        prior = rng.dirichlet(np.ones(A), N).astype(np.float32)
        # uniform priors give exact score ties among unvisited children,
        # which the tie-break then decides
        prior[rng.random(N) < 0.3] = 1.0 / A
        legal = rng.random((N, A)) > 0.15
        legal[np.arange(N), rng.integers(0, A, N)] = True
        legal |= children >= 0
        if b % 3 == 0:
            # a chain whose only legal moves lead down it: a deep descent
            legal[:-1] = children[:-1] >= 0
        safe = np.maximum(children, 0)
        exists = children >= 0
        row = packed[b]
        row[:, 0:A] = children
        row[:, A : 2 * A] = prior
        row[:, 2 * A : 3 * A] = legal
        row[:, 3 * A : 4 * A] = np.where(exists, visits[safe], 0)
        row[:, 4 * A : 5 * A] = np.where(exists, vsum[safe], 0)
        row[:, 5 * A : 6 * A] = np.where(exists, reward[safe], 0)
        row[:, 6 * A : 7 * A] = np.where(exists, terminal[safe], 0)
        row[:, 7 * A] = visits
    vmin = (rng.standard_normal(B) - 1.0).astype(np.float32)
    vmax = (vmin + rng.random(B) * 2.0).astype(np.float32)
    vmax[: max(1, B // 8)] = vmin[: max(1, B // 8)]  # normalization off
    root_stats = np.stack(
        [np.zeros(B), rng.standard_normal(B), packed[:, 0, 7 * A], np.zeros(B)],
        axis=1,
    ).astype(np.float32)
    noise = rng.random((N + 1, B, A)).astype(np.float32) if with_noise else None
    return dict(packed=packed, vmin=vmin, vmax=vmax, root_stats=root_stats, noise_u=noise)
