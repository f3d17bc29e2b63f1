#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (lightzero_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of a fixed size, in one process:
  1. card: the GPU's name and power limit (nvidia-smi);
  2. build: nvcc compiles every kernel of the port into lightzero_tpu_torch/_build/;
  3. kernel vs plain: each kernel against its plain PyTorch version on the card,
     on numpy-seeded inputs at the shapes the main path gives it;
  4. the main path: the Evaluator plays CartPole with the CartPole MuZero config
     at full width (25 simulations, 3 envs) until each env ends an episode,
     with the launch counters read around it; then a small batch searched on
     the card agrees with the same search on the CPU;
  5. bench shape: batch_puct_search through MuZeroPolicy at bench.py's shapes
     (B=1024, 50 simulations), once through the kernel and once through the
     plain descent on the card; equal visit counts.

The last lines are the card's name and power limit, one JSON object with a
record per kernel, and {"ok": true, "device": {...}}; that last line is printed
only when every phase passed. Without a CUDA device the script exits non-zero
and prints no result. A watchdog ends a run that has not finished in 290 s.
"""
from __future__ import annotations

import copy
import dataclasses
import faulthandler
import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from lightzero_tpu_torch import _build
from lightzero_tpu_torch.configs.cartpole_muzero import main_config
from lightzero_tpu_torch.envs import CartPoleEnv
from lightzero_tpu_torch.models.common import lecun_normal_
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.search import puct
from lightzero_tpu_torch.search.fused_traverse import (
    check_inputs,
    fused_traverse,
    fused_traverse_reference,
)
from lightzero_tpu_torch.workers import Evaluator

WATCHDOG_S = 290
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside the
# tensor cores; the bound of a kernel is the larger of bytes/rate, ops/rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations the descent does per tree and depth level (log, sqrt, the
# mean-Q divisions) and per action and level (child value, pUCT score,
# normalisation, clip, argmax; a second scoring pass for the noise tie-break)
OPS_PER_LEVEL = 16
OPS_PER_ACTION = {True: 30, False: 52}
# kernel vs plain: path, action, depth, parent, leaf and flags exact; the
# recorded stats are copies of table entries and must agree to 1e-6
STATS_RTOL = STATS_ATOL = 1e-6
# card vs CPU search on the same weights: float32 matmuls in another order
VALUE_TOL = 1e-4

MAIN_SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _watchdog(signum, frame):
    print(f"chip_smoke: watchdog: the run did not finish within {WATCHDOG_S} s",
          file=sys.stderr, flush=True)
    os._exit(3)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def randomize_heads(model, seed: int) -> None:
    """Draw every head's last layer (zero at init, which would make each
    search a tie) from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    heads = (model.dynamics_network.reward_head, model.prediction_network.value_head,
             model.prediction_network.policy_head)
    for head in heads:
        w = head.dense[-1].weight
        w.data.copy_(lecun_normal_(torch.empty(w.shape), g))


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip().splitlines()[0]
    print(out, flush=True)
    return out


def phase_build() -> dict:
    t0 = time.perf_counter()
    path = _build.compile_library("fused_traverse")
    _build.load("fused_traverse")
    seconds = time.perf_counter() - t0
    log_path = path[: -len(".so")] + ".log"
    log = open(log_path).read() if os.path.exists(log_path) else ""
    rec = dict(phase="build", seconds=seconds, nvcc_seconds=_build.build_seconds,
               library=os.path.relpath(path), compiler_output=log.strip().splitlines()[-6:])
    emit(rec)
    return rec


def traverse_case(B: int, A: int, N: int, first: bool, seed: int) -> dict:
    """The kernel and its plain version on the card on the same inputs."""
    d = check_inputs(np.random.default_rng(seed), B, A, N, with_noise=not first)
    args = [None if d[k] is None else torch.from_numpy(d[k]).cuda()
            for k in ("packed", "vmin", "vmax", "root_stats", "noise_u")]
    kw = dict(A=A, N=N, max_depth=N + 1, discount=0.997, pb_c_base=19652.0, pb_c_init=1.25,
              value_delta_max=0.01, tie_break_first=first, tie_break_epsilon=1e-6)
    got = fused_traverse(*args, **kw)
    exp = fused_traverse_reference(*args, **kw)
    torch.cuda.synchronize()
    exact = [got[0][:, :5], got[1], got[2]], [exp[0][:, :5], exp[1], exp[2]]
    mismatches = sum(int((g != e).sum()) for g, e in zip(*exact))
    mismatches += sum(
        int((~torch.isclose(g, e, rtol=STATS_RTOL, atol=STATS_ATOL)).sum())
        for g, e in zip(got[3:], exp[3:])
    )
    max_abs_err = max(float((g - e).abs().max()) for g, e in zip(got, exp))
    ms = cuda_ms(lambda: fused_traverse(*args, **kw), reps=200)
    plain_ms = cuda_ms(lambda: fused_traverse_reference(*args, **kw), reps=3, warmup=1)

    # the least the card could take: the rows each descent visits (depth+1
    # distinct rows), the per-tree inputs and noise rows it reads, its outputs
    D = N + 1
    depth = exp[0][:, 3].double()
    C = 7 * A + 2
    bytes_moved = 4 * (
        float((depth + 1).sum()) * C + B * (1 + 1 + 4)
        + (0 if first else (D - 1) * B * A) + B * (8 + 5 * D)
    )
    ops = (D - 1) * B * (OPS_PER_LEVEL + OPS_PER_ACTION[first] * A)
    bound_s = max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
    rec = dict(
        phase="kernel_vs_plain", kernel="fused_traverse", B=B, A=A, N=N,
        tie_break="first" if first else "noise", mismatches=mismatches,
        max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
        bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S else "operations",
        bytes=bytes_moved, ops=ops, max_depth_reached=int(depth.max()),
    )
    emit(rec)
    return rec


def phase_kernel_vs_plain() -> list:
    cases = []
    # (B, A, N): the CartPole eval (3 envs, 25 sims), the CartPole batch of
    # 8, and bench.py's shape (B=1024, A=4, 50 sims)
    for i, (B, A, N) in enumerate([(3, 2, 26), (8, 2, 26), (1024, 4, 51)]):
        for first in (False, True):
            cases.append(traverse_case(B, A, N, first, seed=100 + i))
    bad = [c for c in cases if c["mismatches"]]
    if bad:
        raise AssertionError(f"fused_traverse disagrees with its plain version: {bad}")
    return cases


def phase_main_path(card: str) -> dict:
    policy = MuZeroPolicy(main_config.policy, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 1)
    sims = policy.search_cfg.num_simulations
    evaluator = Evaluator(CartPoleEnv(), policy, num_envs=3, seed=MAIN_SEED, device="cuda")

    fused_traverse.launches = 0
    t0 = time.perf_counter()
    result = evaluator.eval(max_steps=200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_traverse": fused_traverse.launches}

    steps = result["env_steps"]
    returns = result["episode_returns"]
    rec = dict(phase="main_path", config="cartpole_muzero", num_envs=3, num_simulations=sims,
               episode_returns=returns, env_steps=steps, searches=steps,
               launches=launches, wall_s=wall, card=card)
    emit(rec)
    if launches["fused_traverse"] != steps * sims:
        raise AssertionError(f"traverse launches {launches} != env steps {steps} x {sims}")
    if len(returns) < 3 or not all(math.isfinite(r) and 1 <= r <= 200 for r in returns):
        raise AssertionError(f"implausible CartPole returns {returns}")

    # a small batch searched on the card agrees with the same search on the
    # CPU (the plain descent, held against the JAX package by the tests)
    obs = torch.from_numpy(
        (np.random.default_rng(MAIN_SEED).standard_normal((4, 4)) * 0.1).astype(np.float32))
    legal = torch.ones((4, 2), dtype=torch.bool)
    on_card = policy.forward_eval(obs.cuda(), legal.cuda())
    cpu_policy = MuZeroPolicy(main_config.policy, model=copy.deepcopy(policy.model).cpu(),
                              device="cpu")
    on_cpu = cpu_policy.forward_eval(obs, legal)
    for key in ("action", "visit_counts"):
        if not torch.equal(on_card[key].cpu(), on_cpu[key]):
            raise AssertionError(f"card and CPU searches differ in {key}: "
                                 f"{on_card[key].tolist()} vs {on_cpu[key].tolist()}")
    for key in ("searched_value", "predicted_value"):
        a, b = on_card[key].cpu(), on_cpu[key]
        if not (torch.isfinite(a).all() and torch.allclose(a, b, rtol=VALUE_TOL, atol=VALUE_TOL)):
            raise AssertionError(f"card and CPU {key} differ: {a.tolist()} vs {b.tolist()}")
    emit(dict(phase="card_vs_cpu", batch=4, visit_counts=on_card["visit_counts"].tolist(),
              searched_value=on_card["searched_value"].tolist()))
    return rec


def phase_bench_shape(card: str) -> dict:
    cfg = MuZeroPolicy.default_config()
    cfg.model.observation_shape = 8
    cfg.model.action_space_size = 4
    cfg.model.latent_state_dim = 128
    cfg.model.support_scale = 300
    cfg.num_simulations = 50
    policy = MuZeroPolicy(cfg, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 2)
    policy.search_cfg = dataclasses.replace(policy.search_cfg, tie_break="first")
    B = 1024
    obs = torch.from_numpy(
        np.random.default_rng(MAIN_SEED).standard_normal((B, 8)).astype(np.float32)).cuda()
    legal = torch.ones((B, 4), dtype=torch.bool, device="cuda")

    policy.forward_eval(obs, legal)  # warm-up: cuBLAS handles, caching allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with_kernel = policy.forward_eval(obs, legal)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0

    puct.fused_traverse = fused_traverse_reference
    try:
        t0 = time.perf_counter()
        plain = policy.forward_eval(obs, legal)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        puct.fused_traverse = fused_traverse
    equal = torch.equal(with_kernel["visit_counts"], plain["visit_counts"])
    rec = dict(phase="bench_shape", B=B, A=4, num_simulations=50,
               search_s_kernel=kernel_s, search_s_plain=plain_s,
               sims_per_s_kernel=B * 50 / kernel_s, sims_per_s_plain=B * 50 / plain_s,
               visit_counts_equal=equal, card=card)
    emit(rec)
    if not equal:
        diff = (with_kernel["visit_counts"] != plain["visit_counts"]).any(dim=1).sum().item()
        raise AssertionError(f"kernel and plain searches differ in {diff} of {B} trees")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU", file=sys.stderr)
        return 2
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(WATCHDOG_S)
    # backstop for a hang inside native code, where SIGALRM's handler cannot run
    faulthandler.dump_traceback_later(WATCHDOG_S + 5, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = phase_card()
    build = phase_build()
    cases = phase_kernel_vs_plain()
    main_rec = phase_main_path(card)
    bench = phase_bench_shape(card)

    main_case = next(c for c in cases if (c["B"], c["A"], c["N"], c["tie_break"]) == (3, 2, 26, "noise"))
    kernels = [dict(
        name="fused_traverse",
        route="cuda",
        source="lightzero_tpu_torch/csrc/fused_traverse.cu",
        replaces="lightzero_tpu/search/pallas_traverse.py:74",
        launches=main_rec["launches"]["fused_traverse"],
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=main_case["ms"],
        plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"],
        bound_by=main_case["bound_by"],
        library_ms=None,
        shape=dict(B=3, A=2, N=26, tie_break="noise"),
    )]
    emit(dict(phase="done", wall_s=time.perf_counter() - t_start,
              build_s=build["seconds"], bench_sims_per_s=bench["sims_per_s_kernel"]))
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
