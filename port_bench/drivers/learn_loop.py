"""The closed loop of learn steps that the multitask and MuZero learn cells
share (``learn_unizero_mt``, ``learn_muzero``): what ``learn_unizero``
does, with the parts that differ given by the cell's driver as a
``Learner``.

``run``: set-up builds the training state, draws the batch pool and drives
the state through its first ``compared_steps`` steps with the window's own
call (``learn_unizero.learn_step``: one ``forward_learn``, the priorities
read back), which warms up every shape; the window then runs ``--seconds``
of steps (with ``--trace 1``, ``trace_steps`` of them under the profiler,
the program's span record and counters cleared first). Once the window has
closed and the program's state is freed, the reference runs the compared
steps from the same weights on the same batches, and the driver's gaps
(``learn_unizero``'s by default) are held to its limits; the other numbers
the gaps give go to ``info``. A step whose loss is not finite (or
that the policy skipped as such) counts as failed.

``readings``: the numbers the limits are set from (``calibrate.py``).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, NamedTuple

import torch

from port_bench import harness
from port_bench.drivers import learn_unizero as base
from port_bench.reference import common as C


class Learner(NamedTuple):
    """The parts of a learn cell's driver that the loop calls."""

    make_batches: Callable  # (config, traffic, seed, device) -> the pool
    program_readings: Callable  # (cell, policy, weights, batches) -> readings with "state"
    reference_readings: Callable  # (cell, weights, batches, rnd, program) -> readings
    planted: Callable  # (fault) -> a context that plants it
    step_flops: Callable  # (cell, batch) -> a learn step's operations
    limits: Dict[str, float]
    gaps: Callable = base.gaps  # (program's readings, reference's) -> the compared numbers


def run(cell: harness.Cell, learner: Learner) -> dict:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    marks = [("imports", time.perf_counter())]
    policy, weights = cell.config_module.build(cfg, cell.seed, dev)
    marks.append(("build", time.perf_counter()))
    batches = learner.make_batches(cfg, tr, cell.seed, dev)
    harness.sync(dev)
    marks.append(("inputs", time.perf_counter()))
    # set-up: the compared steps, which warm up every shape of the window
    program = learner.program_readings(cell, policy, weights, batches)
    state = program.pop("state")
    harness.sync(dev)
    marks.append(("warmup", time.perf_counter()))

    B = int(tr["batch"])
    prof = None
    if cell.trace:
        from lightzero_tpu_torch.utils import profiling

        profiling.record.clear()
        getattr(profiling, "counters", {}).clear()
        prof = torch.profiler.profile(activities=harness.profiler_activities(dev))
        prof.__enter__()
    failed: List[torch.Tensor] = []
    lat: List[float] = []
    setup_s = time.perf_counter() - cell.t_start
    t0 = time.perf_counter()
    try:
        while True:
            ts = time.perf_counter()
            state, logs, _ = base.learn_step(policy, state, batches,
                                             len(failed) + len(program["losses"]))
            failed.append(logs["nonfinite_loss"] > 0 if "nonfinite_loss" in logs
                          else ~torch.isfinite(logs["total_loss"]))
            te = time.perf_counter()
            lat.append(te - ts)
            if (len(failed) >= int(tr["trace_steps"])) if cell.trace else (te - t0 >= cell.seconds):
                break
    finally:
        if cell.trace:
            prof.__exit__(None, None, None)
    wall = te - t0
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    steps = len(failed)
    result = dict(attempted=steps, failed=int(torch.stack(failed).sum()),
                  memory_peak_bytes=peak)
    if cell.trace:
        trace = harness.reduce_trace(prof, wall, base.SPANS)
        del prof
        trace.counters.update(steps=steps, flops=steps * learner.step_flops(cell, B))
        result["trace"] = trace
    else:
        result["metrics"] = dict(learn_samples_per_s=steps * B / wall, setup_s=setup_s)
    del policy, state
    if dev == "cuda":
        torch.cuda.empty_cache()
    ref = learner.reference_readings(cell, weights, batches[:len(program["losses"])],
                                     C.FLOAT32, program)
    g = learner.gaps(program, ref)
    info = {k: v for k, v in g.items() if k not in learner.limits}
    if "routings" in ref:
        info["routings"] = ref["routings"]
    # a window whose first steps are slower than its last warms up inside it
    info.update(first10_ms=harness.percentile(lat[:10], 50) * 1e3,
                last10_ms=harness.percentile(lat[-10:], 50) * 1e3,
                setup_stages_s=harness.stages(cell.t_start, marks))
    result.update(checks=[harness.Check(k, g[k], v) for k, v in learner.limits.items()],
                  info=info)
    return result


def readings(cell: harness.Cell, learner: Learner, faults=()) -> Dict[str, dict]:
    """The compared numbers of the cell's compared steps at its own size,
    without a window, against the float32 reference given the sound
    program's readings: the program's, the program's with each of
    ``faults`` planted, and the control's (the reference in TF32, given the
    same, in the program's place); a reference's ``routings`` beside its
    numbers where it keeps them."""
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    batches = learner.make_batches(cfg, tr, cell.seed, dev)
    runs = {}
    for fault in ("", *faults):
        policy, weights = cell.config_module.build(cfg, cell.seed, dev)
        with learner.planted(fault):
            runs[fault or "program"] = learner.program_readings(cell, policy, weights, batches)
        del policy, runs[fault or "program"]["state"]
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    compared = batches[:int(tr["compared_steps"])]
    ref = learner.reference_readings(cell, weights, compared, C.FLOAT32, runs["program"])
    with harness.hardware_tf32():
        runs["control"] = learner.reference_readings(cell, weights, compared, C.TF32,
                                                     runs["program"])
    out = {}
    for name, r in runs.items():
        out[name] = {k: v for k, v in learner.gaps(r, ref).items()
                     if k in learner.limits or k.startswith("later_")}
    for name, r in (("program", ref), ("control", runs["control"])):
        if "routings" in r:
            out[name]["routings"] = r["routings"]
    return out
