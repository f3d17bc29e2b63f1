"""Closed loop of MuZero learn steps, as the learner of a training run drives
``MuZeroPolicy``: each step is one ``policy.forward_learn(state, batch)`` on
a batch of ``batch`` unrolls of the policy's ``num_unroll_steps`` (the
port's default where the configuration leaves it), then the priorities
read back to the host, which the replay buffer waits for.

The batches are ``learn_unizero``'s (frames of the configuration's
observation shape in [0, 1), uniform actions, masks, sparse rewards,
values, visit distributions, importance weights), a pool of
``batch_pool`` drawn from the seed on the device in set-up and served in
turn. The loop is ``learn_loop``'s: set-up drives a fresh training state
through the first ``compared_steps`` steps with the window's own call and
batches; once the window has closed the plain reference
(``reference/muzero_learn.py``) runs those steps from the same weights on
the same batches, and ``learn_unizero``'s gaps compare them: each step's loss, the first step's
priorities, the norm of the first step's clipped gradient (the gradient the
optimizer took) and the norm of the parameters' change over the steps, the
norms by the worst leaf. A step whose loss is not finite counts as failed.

The learn step's operations from shapes (``flops_learn_step``) are here:
the configuration's module counts inference only.
"""
from __future__ import annotations

from typing import Dict

import torch

from port_bench import flops, harness
from port_bench.drivers import learn_loop
from port_bench.drivers import learn_unizero as base
from port_bench.reference import common as C

# limits (PERF.md gives the readings they were set from)
LIMITS = dict(loss_gap=3e-6, priority_gap=2e-4, grad_gap=2e-5, change_gap=1e-4)
FAULTS = ("unchanged", "half_batch", "altered")


def policy_config(config: dict) -> dict:
    """The cell's policy configuration over the port's MuZero defaults: what
    the policy runs with, and what the reference is given."""
    from lightzero_tpu_torch.config import deep_merge
    from lightzero_tpu_torch.policy import MuZeroPolicy

    return dict(deep_merge(MuZeroPolicy.default_config(), config["policy"]))


def unroll(config: dict) -> int:
    return int(policy_config(config)["num_unroll_steps"])


def make_batches(config: dict, traffic: dict, seed: int, device: str) -> list:
    policy = dict(config["policy"], num_unroll_steps=unroll(config))
    return base.make_batches(dict(config, policy=policy), traffic, seed, device)


def run(cell: harness.Cell) -> dict:
    return learn_loop.run(cell, LEARNER)


def reference_readings(cell: harness.Cell, weights, batches: list, rnd: C.Rounding = C.FLOAT32,
                       program=None) -> dict:
    """The reference's steps from ``weights`` on ``batches``, in the form the
    program's readings take (``program`` is not needed)."""
    from port_bench.reference import muzero_learn

    as_dicts = [dict(obs=b.obs, actions=b.actions, mask=b.mask, target_reward=b.target_reward,
                     target_value=b.target_value, target_policy=b.target_policy,
                     weights=b.weights) for b in batches]
    losses, grads, change, prios = muzero_learn.learn_steps(weights, policy_config(cell.config),
                                                            as_dicts, rnd)
    return dict(losses=losses, priorities=[p.cpu() for p in prios],
                grad_norms={k: float(torch.linalg.vector_norm(v)) for k, v in grads.items()},
                change_norms={k: float(torch.linalg.vector_norm(v)) for k, v in change.items()})


# ------------------------------------------------------------- readings

def program_readings(cell: harness.Cell, policy, weights, batches: list) -> dict:
    """The compared steps from a fresh training state, as set-up takes them;
    the first step's gradients are read from the parameters right after it
    (the clipped gradient the optimizer took)."""
    state = policy.init_train_state()
    losses, prios, first_grads = [], [], None
    for i in range(int(cell.traffic["compared_steps"])):
        state, logs, prio = base.learn_step(policy, state, batches, i)
        losses.append(float(logs["total_loss"]))
        prios.append(prio)
        if i == 0:
            first_grads = {n: float(torch.linalg.vector_norm(p.grad))
                           for n, p in state.model.named_parameters()}
    change = {n: float(torch.linalg.vector_norm(p.detach() - weights[n]))
              for n, p in state.model.named_parameters()}
    return dict(losses=losses, priorities=prios, grad_norms=first_grads, change_norms=change,
                state=state)


def readings(cell: harness.Cell, faults=()) -> Dict[str, dict]:
    return learn_loop.readings(cell, LEARNER, faults)


class planted(harness.Patches):
    """A fault planted in the program for the duration of a block:
    'unchanged' (the optimizer's step leaves the parameters as they were),
    'half_batch' (the loss of half the rows stands in for the other half's),
    'altered' (the first row's priority doubled where the loss produces
    it); '' plants nothing."""

    def __init__(self, fault: str):
        super().__init__()
        self.fault = fault

    def __enter__(self):
        from lightzero_tpu_torch.policy.muzero import MuZeroPolicy

        orig = MuZeroPolicy._sample_losses
        if self.fault == "unchanged":
            self.swap(torch.optim.SGD, "step", lambda opt, closure=None: None)
        elif self.fault == "half_batch":
            def half(policy, *a, **k):
                loss, logs, prio = orig(policy, *a, **k)
                h = loss.shape[0] // 2
                return torch.cat([loss[:h], loss[:h]]), logs, prio

            self.swap(MuZeroPolicy, "_sample_losses", half)
        elif self.fault == "altered":
            def altered(policy, *a, **k):
                loss, logs, prio = orig(policy, *a, **k)
                return loss, logs, torch.cat([2.0 * prio[:1], prio[1:]])

            self.swap(MuZeroPolicy, "_sample_losses", altered)
        elif self.fault:
            raise ValueError(f"unknown fault {self.fault!r}")
        return self


def flops_learn_step(config_module, config: dict, batch: int) -> float:
    """A learn step's operations from shapes (``config_module`` the
    configuration's module, which counts the inferences): the initial
    inference and the K recurrent ones, forward and backward (the backward
    twice the forward's operations, less the first convolution's input
    gradient); the SSL projection with its predictor at each of the K
    latents, likewise; and at each step the target's representation and
    projection, forward only (no gradient)."""
    m = config["policy"]["model"]
    H, W, c_in = m["observation_shape"]
    h, w = flops.latent_hw(m["observation_shape"])
    c = int(m["num_channels"])
    K = unroll(config)
    # the projector's widths: the model's defaults where the file sets none
    hid, out = int(m.get("proj_hid", 1024)), int(m.get("proj_out", 1024))
    pred_hid, pred_out = int(m.get("pred_hid", 512)), int(m.get("pred_out", 1024))
    projection = flops.linear(h * w * c, hid) + flops.linear(hid, hid) + flops.linear(hid, out)
    predictor = flops.linear(out, pred_hid) + flops.linear(pred_hid, pred_out)
    representation = (flops.downsample(H, W, c_in, c)
                      + flops.res_blocks(h, w, c, int(m["num_res_blocks"])))
    graded = (config_module.flops_initial(config) + K * config_module.flops_recurrent(config)
              + K * (projection + predictor))
    first = flops.conv(flops.ceil_half(H), flops.ceil_half(W), c_in, c // 2, 3)
    return batch * (3 * graded - first + K * (representation + projection))


def step_flops(cell: harness.Cell, batch: int) -> float:
    return flops_learn_step(cell.config_module, cell.config, batch)


LEARNER = learn_loop.Learner(make_batches, program_readings, reference_readings, planted,
                             step_flops, LIMITS)
