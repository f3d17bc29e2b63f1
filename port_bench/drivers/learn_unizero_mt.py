"""Closed loop of ScaleZero's multitask learn steps, as the learner of a
multitask training run drives ``UniZeroMTPolicy``: each step is one
``policy.forward_learn(state, batch)`` (the default path, no gradient
correction) on an ``MTTrainBatch`` of ``tasks`` tasks x ``batch / tasks``
rows, then the priorities read back to the host, which the replay buffer
waits for.

The batches are ``learn_unizero``'s, their rows grouped ``batch / tasks`` a
task (task ids 0, 0, ..., 1, ...), with uniform task weights. Set-up, the
window and the comparison are ``learn_loop``'s: the first
``compared_steps`` steps, driven by the window's own call from a fresh
state, against the plain reference (``reference/unizero_moe.py``) once the
window has closed, by loss_gap (the first step's), priority_gap,
grad_gap and change_gap.
During those steps a forward hook on every MoE gate keeps the program's
gate logits; the reference takes the program's selection for the
token-layers whose two competing logits lie under its ``PIN_MARGIN``
apart, and runs the rows ``reference_rows`` at a time. ``info`` carries
each step's tally of those routings.

A traced run's readers read the program's ``moe.*`` spans and its
``moe.tokens_per_expert`` counter after the window.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from port_bench import harness
from port_bench.drivers import learn_loop
from port_bench.drivers import learn_unizero as base
from port_bench.reference import common as C

# limits (PERF.md gives the readings they were set from)
LIMITS = dict(loss_gap=1e-6, priority_gap=5e-4, grad_gap=5e-4, change_gap=3e-3)
FAULTS = base.FAULTS + ("no_shared", "dense_eighth", "dropped_expert")


def make_batches(config: dict, traffic: dict, seed: int, device: str) -> list:
    from lightzero_tpu_torch.policy.multitask import attach_task_fields

    tasks, B = int(traffic["tasks"]), int(traffic["batch"])
    task_id = torch.arange(B, device=device) // (B // tasks)
    task_weights = torch.ones(tasks, device=device)
    return [attach_task_fields(b, task_id, task_weights)
            for b in base.make_batches(config, traffic, seed, device)]


def run(cell: harness.Cell) -> dict:
    return learn_loop.run(cell, LEARNER)


def reference_readings(cell: harness.Cell, weights, batches: list, rnd: C.Rounding = C.FLOAT32,
                       program=None) -> dict:
    """The reference's steps from ``weights`` on ``batches``, in the form the
    program's readings take, with its routings' tallies: pinned to
    ``program``'s gate logits where given, the rows ``reference_rows`` at a
    time."""
    from port_bench.reference import unizero_moe

    as_dicts = [dict(obs=b.obs, actions=b.actions, mask=b.mask, target_reward=b.target_reward,
                     target_value=b.target_value, target_policy=b.target_policy,
                     weights=b.weights, task_id=b.task_id, task_weights=b.task_weights)
                for b in batches]
    losses, grads, change, prios, tallies = unizero_moe.learn_steps(
        weights, cell.config["policy"], as_dicts, rnd,
        None if program is None else program["gate_logits"], int(cell.traffic["reference_rows"]))
    return dict(losses=losses, priorities=[p.cpu() for p in prios],
                grad_norms={k: float(torch.linalg.vector_norm(v)) for k, v in grads.items()},
                change_norms={k: float(torch.linalg.vector_norm(v)) for k, v in change.items()},
                routings=tallies)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``learn_unizero``'s gaps, with the loss compared at the first step
    only, as the priorities are: the later steps' losses rest on parameters
    that AdamW has moved by its own round-off (a gradient near zero takes a
    step of +-lr either way, and the experts that few tokens reach have
    many), which moves them as far as TF32 does (PERF.md §2). The later
    steps are held by the parameters' change; their loss gap is printed."""
    g = base.gaps(prog, ref)
    rel = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    g.update(loss_gap=rel[0], later_loss_gap=max(rel[1:], default=0.0))
    return g


def step_flops(cell: harness.Cell, batch: int) -> float:
    return cell.config_module.flops_learn_step(cell.config, batch)


# ------------------------------------------------------------- readings

def program_readings(cell: harness.Cell, policy, weights, batches: list) -> dict:
    """``learn_unizero``'s readings of the compared steps, with every MoE
    gate's logits of each step (``gate_logits``: per step, one (B T, E)
    tensor a layer)."""
    from lightzero_tpu_torch.models.unizero_world_model.moe import MoELayer

    gates = [m.gate for m in policy.model.modules() if isinstance(m, MoELayer)]
    logits: List[torch.Tensor] = []
    hooks = [g.register_forward_hook(lambda mod, inp, out: logits.append(out.detach()))
             for g in gates]
    try:
        out = base.program_readings(cell, policy, weights, batches)
    finally:
        for hook in hooks:
            hook.remove()
    out["gate_logits"] = [logits[i:i + len(gates)] for i in range(0, len(logits), len(gates))]
    return out


def readings(cell: harness.Cell, faults=()) -> Dict[str, dict]:
    """``learn_loop.readings``: the reference (and the control, the
    reference in TF32) pinned to the sound program's near-tie routings."""
    return learn_loop.readings(cell, LEARNER, faults)


class planted(harness.Patches):
    """A fault planted in the program for the duration of a block:
    ``learn_unizero``'s ('unchanged', 'half_batch', 'altered'), and three of
    the MoE layer: 'no_shared' (the shared expert left out of the sum),
    'dense_eighth' (every expert on every token, each weighed 1/E, as a
    dense mixture without a router would be), 'dropped_expert' (the tokens
    routed to expert 0 left out of its product); '' plants nothing."""

    def __init__(self, fault: str):
        super().__init__()
        self.fault = fault
        self.base = base.planted(fault if fault in base.FAULTS else "")

    def __enter__(self):
        from lightzero_tpu_torch.models.unizero_world_model import moe

        self.base.__enter__()
        if self.fault == "no_shared":
            forward = moe.MoELayer.forward

            def no_shared(layer, x):
                shared, layer.shared = layer.shared, None
                try:
                    return forward(layer, x)
                finally:
                    layer.shared = shared

            self.swap(moe.MoELayer, "forward", no_shared)
        elif self.fault == "dense_eighth":
            def every_expert(gate_logits, k):
                E = gate_logits.shape[-1]
                return (torch.ones_like(gate_logits, dtype=torch.bool),
                        torch.full_like(gate_logits, 1.0 / E))

            self.swap(moe, "select", every_expert)
        elif self.fault == "dropped_expert":
            group = moe.group_by_expert

            def dropped(chosen, weights):
                token, weight, sizes = group(chosen, weights)
                return token[sizes[0]:], weight[sizes[0]:], [0] + sizes[1:]

            self.swap(moe, "group_by_expert", dropped)
        elif self.fault and self.fault not in base.FAULTS:
            raise ValueError(f"unknown fault {self.fault!r}")
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        return self.base.__exit__(*exc)


LEARNER = learn_loop.Learner(make_batches, program_readings, reference_readings, planted,
                             step_flops, LIMITS, gaps)
