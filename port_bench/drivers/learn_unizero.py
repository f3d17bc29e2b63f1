"""Closed loop of UniZero learn steps, as the learner of a training run
drives ``UniZeroPolicy``: each step is one ``policy.forward_learn(state,
batch)`` on a batch of ``batch`` unrolls, then the priorities read back to
the host, which the replay buffer waits for.

Batches have the type ``GameBuffer.sample`` returns (``TrainBatch`` on the
device): float32 frames in [0, 1), uniform actions, masks that end each row
after 5 to K steps, sparse rewards in {-1, 0, 1}, values in [-2, 2),
softmaxed visit distributions zeroed past each row's end, importance
weights in (0.3, 1] over their maximum. A pool of ``batch_pool`` of them is
drawn from the seed on the device in set-up and served in turn.

Set-up builds the training state once, drives it through its first
``compared_steps`` steps with the window's own call and batches (the first
three of the pool, whose rows all differ), and hands the same state to the
window. Once the window has closed the reference runs those steps from the
same weights on the same batches; what is compared: each step's loss, the
first step's priorities, the norm of the first step's gradient as the optimizer
got it (from AdamW's first moment after one step) and the norm of the
parameters' change over the steps, the norms by the worst leaf. The change
leaves out the leaves whose reference gradient is under a thousandth of the
median leaf's: AdamW moves those by round-off alone.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from port_bench import harness
from port_bench.reference import common as C

SPANS = ("learn_step", "batch_next")
POOL_KEY = 2
BETA1 = 0.9
# limits (PERF.md gives the readings they were set from)
LIMITS = dict(loss_gap=1e-5, priority_gap=2e-4, grad_gap=5e-5, change_gap=3e-3)


def make_batches(config: dict, traffic: dict, seed: int, device: str) -> list:
    from lightzero_tpu_torch.policy.muzero import TrainBatch

    p = config["policy"]
    A, K = int(p["model"]["action_space_size"]), int(p["num_unroll_steps"])
    P, B = int(traffic["batch_pool"]), int(traffic["batch"])
    g = harness.generator(device, harness.derive(seed, POOL_KEY))
    obs = torch.rand((P, B, K + 1, *p["model"]["observation_shape"]), generator=g, device=device)
    actions = torch.randint(0, A, (P, B, K), generator=g, device=device)
    length = torch.randint(K // 2, K + 1, (P, B, 1), generator=g, device=device)
    mask = (torch.arange(K, device=device) < length).to(torch.float32)
    reward = torch.randint(-1, 2, (P, B, K), generator=g, device=device).to(torch.float32)
    reward = reward * (torch.rand((P, B, K), generator=g, device=device) < 0.1) * mask
    value = torch.rand((P, B, K + 1), generator=g, device=device) * 4.0 - 2.0
    policy = torch.softmax(2.0 * torch.randn((P, B, K + 1, A), generator=g, device=device), dim=-1)
    valid = torch.cat([torch.ones((P, B, 1), device=device), mask], dim=-1)
    policy = policy * valid[..., None]
    weights = torch.rand((P, B), generator=g, device=device) * 0.7 + 0.3
    weights = weights / weights.max(dim=1, keepdim=True).values
    chance = torch.zeros((P, B, K), dtype=torch.long, device=device)
    return [TrainBatch(obs=obs[i], actions=actions[i], mask=mask[i], target_reward=reward[i],
                       target_value=value[i], target_policy=policy[i], weights=weights[i],
                       chance=chance[i]) for i in range(P)]


def learn_step(policy, state, batches: list, i: int):
    with record_function("batch_next"):
        batch = batches[i % len(batches)]
    with record_function("learn_step"):
        state, logs, priority = policy.forward_learn(state, batch)
        priority = priority.cpu()
    return state, logs, priority


def run(cell: harness.Cell) -> dict:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    marks = [("imports", time.perf_counter())]
    policy, weights = cell.config_module.build(cfg, cell.seed, dev)
    marks.append(("build", time.perf_counter()))
    batches = make_batches(cfg, tr, cell.seed, dev)
    harness.sync(dev)
    marks.append(("inputs", time.perf_counter()))
    # set-up: the compared steps, which warm up every shape of the window
    program = program_readings(cell, policy, weights, batches)
    state = program.pop("state")
    harness.sync(dev)
    marks.append(("warmup", time.perf_counter()))

    B = int(tr["batch"])
    prof = None
    if cell.trace:
        prof = torch.profiler.profile(activities=harness.profiler_activities(dev))
        prof.__enter__()
    flags: List[torch.Tensor] = []
    lat: List[float] = []
    setup_s = time.perf_counter() - cell.t_start
    t0 = time.perf_counter()
    try:
        while True:
            ts = time.perf_counter()
            state, logs, _ = learn_step(policy, state, batches, len(flags) + len(program["losses"]))
            flags.append(logs["nonfinite_loss"])
            te = time.perf_counter()
            lat.append(te - ts)
            if (len(flags) >= int(tr["trace_steps"])) if cell.trace else (te - t0 >= cell.seconds):
                break
    finally:
        if cell.trace:
            prof.__exit__(None, None, None)
    wall = te - t0
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    steps = len(flags)
    result = dict(attempted=steps, failed=int(sum(float(f) for f in flags)),
                  memory_peak_bytes=peak)
    if cell.trace:
        trace = harness.reduce_trace(prof, wall, SPANS)
        del prof
        trace.counters.update(steps=steps, flops=steps * cell.config_module.flops_learn_step(cfg, B))
        result["trace"] = trace
    else:
        result["metrics"] = dict(learn_samples_per_s=steps * B / wall, setup_s=setup_s)
    del policy, state
    if dev == "cuda":
        torch.cuda.empty_cache()
    checks, info = compare(cfg, weights, batches[:len(program["losses"])], program)
    # a window whose first steps are slower than its last warms up inside it
    info.update(first10_ms=harness.percentile(lat[:10], 50) * 1e3,
                last10_ms=harness.percentile(lat[-10:], 50) * 1e3,
                setup_stages_s=harness.stages(cell.t_start, marks))
    result.update(checks=checks, info=info)
    return result


def reference_readings(config: dict, weights, batches: list, rnd: C.Rounding = C.FLOAT32) -> dict:
    """The reference's steps from ``weights`` on ``batches``, in the form the
    program's readings take."""
    from port_bench.reference import unizero

    as_dicts = [dict(obs=b.obs, actions=b.actions, mask=b.mask, target_reward=b.target_reward,
                     target_value=b.target_value, target_policy=b.target_policy,
                     weights=b.weights) for b in batches]
    losses, grads, change, prios = unizero.learn_steps(weights, config["policy"], as_dicts, rnd)
    norm = {k: float(torch.linalg.vector_norm(v)) for k, v in grads.items()}
    return dict(losses=losses, priorities=[p.cpu() for p in prios], grad_norms=norm,
                change_norms={k: float(torch.linalg.vector_norm(v)) for k, v in change.items()})


def row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows |prog - ref| / max(|ref|, the median row's |ref|)."""
    prog, ref = prog.double(), ref.double()
    return float(((prog - ref).abs() / torch.clamp(ref.abs(), min=float(ref.abs().median()))).max())


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    # the first step's priorities: the later steps' rest on parameters that
    # AdamW has moved by its own round-off (a gradient near zero takes a
    # step of +-lr either way), which the priorities magnify by h^-1
    prio = [row_gap(a, b) for a, b in zip(prog["priorities"], ref["priorities"])]
    grad_gap, grad_leaf = harness.worst_leaf_gap(prog["grad_norms"], ref["grad_norms"])
    med = sorted(ref["grad_norms"].values())[len(ref["grad_norms"]) // 2]
    moved = [k for k, g in ref["grad_norms"].items() if g >= 1e-3 * med]
    change_gap, change_leaf = harness.worst_leaf_gap(prog["change_norms"], ref["change_norms"],
                                                     moved)
    return dict(loss_gap=loss_gap, priority_gap=prio[0], grad_gap=grad_gap,
                later_priority_gap=max(prio[1:], default=0.0),
                change_gap=change_gap, grad_leaf=grad_leaf, change_leaf=change_leaf,
                left_out=sorted(set(ref["grad_norms"]) - set(moved)))


def compare(config: dict, weights, batches: list, program: dict) -> tuple:
    g = gaps(program, reference_readings(config, weights, batches))
    checks = [harness.Check(k, g[k], LIMITS[k]) for k in LIMITS]
    return checks, {k: g[k] for k in ("grad_leaf", "change_leaf", "left_out", "later_priority_gap")}


# ------------------------------------------------------------- readings

FAULTS = ("unchanged", "half_batch", "altered")


def program_readings(cell: harness.Cell, policy, weights, batches: list) -> dict:
    """The compared steps from a fresh training state, as set-up takes them."""
    state = policy.init_train_state()
    names = dict((p, n) for n, p in state.model.named_parameters())
    losses, prios, first_grads = [], [], None
    for i in range(int(cell.traffic["compared_steps"])):
        state, logs, prio = learn_step(policy, state, batches, i)
        losses.append(float(logs["total_loss"]))
        prios.append(prio)
        if i == 0:
            first_grads = {names[p]: float(torch.linalg.vector_norm(s["exp_avg"])) / (1.0 - BETA1)
                           for p, s in state.optimizer.state.items()}
    change = {n: float(torch.linalg.vector_norm(p.detach() - weights[n]))
              for n, p in state.model.named_parameters()}
    return dict(losses=losses, priorities=prios, grad_norms=first_grads, change_norms=change,
                state=state)


def readings(cell: harness.Cell, faults=()) -> Dict[str, dict]:
    """The compared numbers of the cell's compared steps at its own size,
    without a window, against the float32 reference: the program's, the
    program's with each of ``faults`` planted, and the control's (the
    reference in TF32 in the program's place)."""
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    batches = make_batches(cfg, tr, cell.seed, dev)
    runs = {}
    for fault in ("", *faults):
        policy, weights = cell.config_module.build(cfg, cell.seed, dev)
        with planted(fault):
            runs[fault or "program"] = program_readings(cell, policy, weights, batches)
        del policy, runs[fault or "program"]["state"]
    compared = batches[:int(tr["compared_steps"])]
    ref = reference_readings(cfg, weights, compared)
    with harness.hardware_tf32():
        runs["control"] = reference_readings(cfg, weights, compared, C.TF32)
    return {name: {k: v for k, v in gaps(r, ref).items() if k in LIMITS or k == "later_priority_gap"}
            for name, r in runs.items()}


class planted(harness.Patches):
    """A fault planted in the program for the duration of a block:
    'unchanged' (the optimizer's step leaves the parameters as they were),
    'half_batch' (the loss of half the rows stands in for the other half's,
    so the mean is taken over half the batch), 'altered' (the first row's
    priority doubled where the loss produces it); '' plants nothing."""

    def __init__(self, fault: str):
        super().__init__()
        self.fault = fault

    def __enter__(self):
        from lightzero_tpu_torch.policy.unizero import UniZeroPolicy

        orig = UniZeroPolicy._sample_losses
        if self.fault == "unchanged":
            self.swap(torch.optim.AdamW, "step", lambda opt, closure=None: None)
        elif self.fault == "half_batch":
            def half(policy, *a, **k):
                loss, extra, logs, prio = orig(policy, *a, **k)
                h = loss.shape[0] // 2
                return torch.cat([loss[:h], loss[:h]]), extra, logs, prio

            self.swap(UniZeroPolicy, "_sample_losses", half)
        elif self.fault == "altered":
            def altered(policy, *a, **k):
                loss, extra, logs, prio = orig(policy, *a, **k)
                return loss, extra, logs, torch.cat([2.0 * prio[:1], prio[1:]])

            self.swap(UniZeroPolicy, "_sample_losses", altered)
        elif self.fault:
            raise ValueError(f"unknown fault {self.fault!r}")
        return self
