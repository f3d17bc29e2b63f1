"""Closed loop of batched collect searches, one call after another, as a
self-play collector with thousands of envs batched on one card drives the
policy: each call searches every root, samples the actions and reads them
back to the host, which is what each env step waits for.

Every call goes through ``policy._forward_collect`` as ``forward_collect``
calls it (temperature and epsilon from the traffic file, every action
legal, one-player roots), with two of its draws handed in so that the
reference can replay them: the root's Dirichlet noise (``noise``, a pool of
``noise_pool`` draws made from the seed in set-up, one a call in turn) and
the tie-break tables, by seeding the policy's generator before each call
from the run's seed and the call's index. Observations are float32 in
[0, 1), a pool of ``obs_pool`` batches drawn from the seed on the device.

What is compared (after the window, on ``compared_calls`` calls drawn from
the seed among those finished): the root policy logits and value of the
initial inference, and, for every tree whose selections all had a margin
of ``MARGIN`` or more in the reference, the visit counts exactly and the
searched value. The trees below the margin are counted, not compared: a
score that close to the tie threshold may go either way under another
order of float32 sums.
"""
from __future__ import annotations

import importlib
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import flops, harness
from port_bench.reference import common as C

SPANS = ("search_call", "batch_next")
POOL_KEY, NOISE_KEY, CALL_KEY, WARM_KEY, SAMPLE_KEY = 2, 3, 4, 5, 6
# a tree is compared exactly when every selection it made in the reference
# had all competing scores at least this far from the tie threshold
MARGIN = 1e-4
MARGINS = (1e-5, 1e-4, 1e-3)
# limits (PERF.md gives the readings they were set from)
LIMITS = dict(logit_gap=1e-4, value_gap=2e-4, visit_mismatch_share=0.1, searched_value_gap=2e-4)
KEPT = ("visit_counts", "searched_value", "predicted_value", "policy_logits")


class Inputs:
    """The benchmark's inputs of every call, made from the run's seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        model = config["policy"]["model"]
        B, A = int(traffic["roots"]), int(model["action_space_size"])
        self.seed, self.device = seed, device
        self.obs = torch.rand((int(traffic["obs_pool"]), B, *model["observation_shape"]),
                              generator=harness.generator(device, harness.derive(seed, POOL_KEY)),
                              device=device)
        alpha = torch.full((int(traffic["noise_pool"]), B, A),
                           float(config["policy"]["root_dirichlet_alpha"]), device=device)
        g = torch._standard_gamma(alpha, generator=harness.generator(
            device, harness.derive(seed, NOISE_KEY)))
        self.noise = g / torch.clamp(g.sum(dim=-1, keepdim=True), min=1e-30)
        self.legal = torch.ones((B, A), dtype=torch.bool, device=device)
        self.to_play = torch.full((B,), -1, dtype=torch.int32, device=device)

    def call(self, i: int, key: int = CALL_KEY):
        """(obs, noise, tie-break seed) of call i."""
        return (self.obs[i % self.obs.shape[0]], self.noise[i % self.noise.shape[0]],
                harness.derive(self.seed, key, i))


def search_call(policy, inputs: Inputs, traffic: dict, i: int, key: int = CALL_KEY):
    with record_function("batch_next"):
        obs, noise, tie_seed = inputs.call(i, key)
    with record_function("search_call"):
        policy.generator.manual_seed(tie_seed)
        out = policy._forward_collect(obs, inputs.legal, inputs.to_play,
                                      float(traffic["temperature"]), float(traffic["epsilon"]),
                                      deterministic=False, noise=noise)
        out["action"].cpu()
    return out


def run(cell: harness.Cell) -> dict:
    import lightzero_tpu_torch.search.puct as puct

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    marks = [("imports", time.perf_counter())]
    policy, weights = cell.config_module.build(cfg, cell.seed, dev)
    marks.append(("build", time.perf_counter()))
    inputs = Inputs(cfg, tr, cell.seed, dev)
    harness.sync(dev)
    marks.append(("inputs", time.perf_counter()))
    for j in range(int(tr["warmup_calls"])):
        search_call(policy, inputs, tr, j, WARM_KEY)
    harness.sync(dev)
    marks.append(("warmup", time.perf_counter()))

    B = int(tr["roots"])
    sims = int(cfg["policy"]["num_simulations"])
    launches: List[torch.Tensor] = []
    prof = None
    if cell.trace:
        # the descent's depths, for its bytes and operations: the scalars
        # each launch returns, kept without a device op of their own
        kernel = puct.fused_traverse

        def counted(*args, **kwargs):
            out = kernel(*args, **kwargs)
            launches.append(out[0])
            return out

        puct.fused_traverse = counted
        prof = torch.profiler.profile(activities=harness.profiler_activities(dev))
        prof.__enter__()
    outs, lat = [], []
    setup_s = time.perf_counter() - cell.t_start
    t0 = time.perf_counter()
    try:
        while True:
            ts = time.perf_counter()
            out = search_call(policy, inputs, tr, len(outs))
            te = time.perf_counter()
            lat.append(te - ts)
            outs.append({k: out[k] for k in KEPT})
            if (len(outs) >= int(tr["trace_calls"])) if cell.trace else (te - t0 >= cell.seconds):
                break
    finally:
        if cell.trace:
            prof.__exit__(None, None, None)
            puct.fused_traverse = kernel
    wall = te - t0
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    calls = len(outs)

    result = dict(attempted=calls, failed=failed_calls(outs, sims), memory_peak_bytes=peak)
    if cell.trace:
        trace = harness.reduce_trace(prof, wall, SPANS)
        del prof
        trace.counters.update(calls=calls, sims=sims, roots=B, flops=calls * B * (
            cell.config_module.flops_initial(cfg) + sims * cell.config_module.flops_recurrent(cfg)))
        A = inputs.legal.shape[1]
        first = policy.search_cfg.tie_break == "first"
        bound_s = 0.0
        for depth_sum in torch.stack([s[:, 3].double().sum() for s in launches]).tolist():
            nbytes, ops = flops.descent_bytes_ops(depth_sum, B, A, sims + 1, first)
            bound_s += max(nbytes / harness.HBM_BYTES_PER_S, ops / harness.FP32_FLOP_PER_S)
        trace.counters.update(descent_launches=len(launches), descent_bound_s=bound_s)
        result["trace"] = trace
    else:
        result["metrics"] = dict(search_sims_per_s=calls * B * sims / wall,
                                 search_ms_p90=harness.percentile(lat, 90) * 1e3,
                                 setup_s=setup_s)
    del policy
    if dev == "cuda":
        torch.cuda.empty_cache()
    checks, info = compare(cell, weights, inputs, outs)
    # a window whose first calls are slower than its last warms up inside it
    info.update(first10_ms=harness.percentile(lat[:10], 50) * 1e3,
                last10_ms=harness.percentile(lat[-10:], 50) * 1e3,
                setup_stages_s=harness.stages(cell.t_start, marks))
    result.update(checks=checks, info=info)
    return result


def failed_calls(outs: List[Dict[str, torch.Tensor]], sims: int) -> int:
    """Calls with a root whose visits do not add up to the simulations, or
    a value that is not finite."""
    bad = 0
    for o in outs:
        ok = (o["visit_counts"].sum(dim=-1) == sims).all() & torch.isfinite(o["searched_value"]).all()
        bad += int(not bool(ok))
    return bad


def compared_calls(seed: int, calls: int, k: int) -> List[int]:
    rng = np.random.default_rng(harness.derive(seed, SAMPLE_KEY))
    return sorted(int(i) for i in rng.choice(calls, size=min(k, calls), replace=False))


def reference_call(cell: harness.Cell, weights, inputs: Inputs, i: int,
                   rnd: C.Rounding = C.FLOAT32) -> Dict[str, torch.Tensor]:
    ref = importlib.import_module(f"port_bench.reference.{cell.config['family']}")
    obs, noise, tie_seed = inputs.call(i)
    return ref.search(weights, cell.config["policy"], obs, inputs.legal, noise,
                      harness.generator(cell.device, tie_seed), rnd)


def gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The compared numbers of one call (see the module's docstring), and
    the share of trees below each of ``MARGINS`` with the share of the
    others that differ (for PERF.md's readings). The searched value's gap is
    taken against the range of the tree's values (what the pUCT score
    normalises by): the root's mean is a sum of terms of that size and may
    cancel to near zero."""
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    same = (prog["visit_counts"] == ref["visit_counts"]).all(dim=-1)
    dv = (prog["searched_value"] - ref["searched_value"]).abs() / ref["value_range"].clamp(min=1e-30)
    out = dict(logit_gap=rel(prog["policy_logits"], ref["policy_logits"]),
               value_gap=rel(prog["predicted_value"], ref["predicted_value"]),
               trees=float(same.numel()))
    for m in MARGINS:
        robust = ref["margin"] >= m
        out[f"robust@{m:g}"] = float(robust.sum())
        out[f"mismatch@{m:g}"] = float((robust & ~same).sum())
        if m == MARGIN:
            out["searched_value_gap"] = float(torch.where(robust & same, dv, 0.0).max())
    return out


def combine(per_call: List[Dict[str, float]]) -> Dict[str, float]:
    """The numbers of the compared calls together: the worst gap, and the
    share of the robust trees whose visits differ, in %."""
    out = {k: max(g[k] for g in per_call) for k in ("logit_gap", "value_gap", "searched_value_gap")}
    trees = sum(g["trees"] for g in per_call)
    for m in MARGINS:
        robust = sum(g[f"robust@{m:g}"] for g in per_call)
        out[f"robust_share@{m:g}"] = 100.0 * robust / trees
        out[f"mismatch_share@{m:g}"] = 100.0 * sum(g[f"mismatch@{m:g}"] for g in per_call) / max(
            robust, 1.0)
    out["visit_mismatch_share"] = out[f"mismatch_share@{MARGIN:g}"]
    return out


def compare(cell: harness.Cell, weights, inputs: Inputs, outs) -> tuple:
    idx = compared_calls(cell.seed, len(outs), int(cell.traffic["compared_calls"]))
    per_call = [gaps(outs[i], reference_call(cell, weights, inputs, i)) for i in idx]
    g = combine(per_call)
    checks = [harness.Check(k, g[k], LIMITS[k]) for k in LIMITS]
    info = {k: v for k, v in g.items() if "@" in k}
    info.update(compared_calls=idx, margin=MARGIN)
    return checks, info



# ------------------------------------------------------------- readings

FAULTS = ("unchanged", "half_batch", "altered")


def readings(cell: harness.Cell, faults=()) -> Dict[str, dict]:
    """The compared numbers of ``compared_calls`` calls of the cell at its own
    size, without a window, against the float32 reference: the program's,
    the program's with each of ``faults`` planted, and the control's (the
    reference in TF32 in the program's place)."""
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    policy, weights = cell.config_module.build(cfg, cell.seed, dev)
    inputs = Inputs(cfg, tr, cell.seed, dev)
    idx = list(range(int(tr["compared_calls"])))

    def program_calls():
        return [{k: v for k, v in search_call(policy, inputs, tr, i).items() if k in KEPT}
                for i in idx]

    runs = {"program": program_calls()}
    for fault in faults:
        with planted(fault):
            runs[fault] = program_calls()
    del policy
    refs = [reference_call(cell, weights, inputs, i) for i in idx]
    with harness.hardware_tf32():
        runs["control"] = [reference_call(cell, weights, inputs, i, C.TF32) for i in idx]
    return {name: combine([gaps(o, r) for o, r in zip(outs, refs)]) for name, outs in runs.items()}


class planted(harness.Patches):
    """A fault planted in the program for the duration of a block:
    'unchanged' (the backup leaves the tree's values as they were), 'half_batch' (half
    the roots searched, their answers given for the rest too), 'altered'
    (every root's visit counts shifted by one action where the search
    returns them)."""

    def __init__(self, fault: str):
        super().__init__()
        self.fault = fault

    def __enter__(self):
        import lightzero_tpu_torch.search.puct as puct
        from lightzero_tpu_torch.policy.muzero import MuZeroPolicy

        if self.fault == "unchanged":
            orig = puct._expand_and_backup

            def frozen(cfg, tree, *a, **k):
                before = tree.value_sum.clone()
                out = orig(cfg, tree, *a, **k)
                out.value_sum.copy_(before)
                return out._replace(vmin=tree.vmin, vmax=tree.vmax)

            self.swap(puct, "_expand_and_backup", frozen)
        elif self.fault == "half_batch":
            orig = MuZeroPolicy._forward_collect

            def half(policy, obs, legal, to_play, *a, noise=None, **k):
                h = obs.shape[0] // 2
                out = orig(policy, obs[:h], legal[:h], to_play[:h], *a, noise=noise[:h], **k)
                return {key: torch.cat([v, v]) for key, v in out.items()}

            self.swap(MuZeroPolicy, "_forward_collect", half)
        elif self.fault == "altered":
            orig = puct.root_visit_counts
            self.swap(puct, "root_visit_counts", lambda tree: torch.roll(orig(tree), 1, dims=-1))
        else:
            raise ValueError(f"unknown fault {self.fault!r}")
        return self
