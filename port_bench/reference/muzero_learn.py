"""Plain reference of MuZero's learn step on the conv model of
``reference/muzero_conv.py`` (Schrittwieser et al. 2020; the SSL
consistency loss of EfficientZero, Ye et al. 2021; LightZero
``lzero/policy/muzero.py``).

One step: the representation of each row's first observation and its
prediction, then K recurrent inferences along the row's actions. The loss
of a row is the policy cross-entropy against the visit distributions and
0.25 x the value cross-entropy against two-hot targets of h(x) at every
one of the K + 1 steps, the reward cross-entropy at the K transitions, and
2 x the SSL loss: at each step k the negative cosine between the predictor
of the projection of the dynamics' latent and the projection (without its
gradient) of the representation of observation k + 1, masked past the
row's end; plus the policy-entropy term at its weight (0 here). The loss
whose gradient the step follows is the importance-weighted mean over K.
The gradient is clipped to a global norm of 10 (scaled by 10 / norm at
or above it), then SGD with momentum takes the step: decay added to the
gradient, the momentum buffer (the first step's gradient to begin with),
the learning rate at its piecewise schedule (x0.1 from half and again from
three quarters of ``threshold_training_steps_for_final_lr``).

The projector (``projector.*``): three Linear -> LayerNorm layers, relu
after the first two, over the latent flattened in (h, w, c) order; the
predictor: Linear -> LayerNorm -> relu -> Linear. The model's departures
are ``reference/muzero_conv.py``'s. ``cfg`` is the policy's configuration
with every key the step reads (the benchmark merges the port's defaults
under the cell's file); ``rnd`` is the format of every conv and matmul
operand (``common.FLOAT32`` or ``common.TF32``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from port_bench.reference import common as C
from port_bench.reference import muzero_conv as M

Batch = Dict[str, torch.Tensor]


def project(p: C.Params, latent: torch.Tensor, with_grad: bool, rnd: C.Rounding) -> torch.Tensor:
    """The projection of a latent, then the predictor where ``with_grad``."""
    x = latent.reshape(latent.shape[0], -1)
    for i in range(3):
        x = C.layer_norm(C.linear(x, p[f"projector.proj.{i}.weight"], p[f"projector.proj.{i}.bias"],
                                  rnd), p, f"projector.proj_norms.{i}")
        if i < 2:
            x = torch.relu(x)
    if not with_grad:
        return x
    y = torch.relu(C.layer_norm(C.linear(x, p["projector.pred.0.weight"], p["projector.pred.0.bias"],
                                         rnd), p, "projector.pred_norm"))
    return C.linear(y, p["projector.pred.1.weight"], p["projector.pred.1.bias"], rnd)


def negative_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-9)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=1e-9)
    return -torch.sum(a * b, dim=-1)


def entropy(logits: torch.Tensor) -> torch.Tensor:
    prob = torch.softmax(logits, dim=-1)
    return -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-9)), dim=-1)


def losses(p: C.Params, cfg: Dict, batch: Batch, rnd: C.Rounding):
    """(the loss whose gradient the step follows, the logged total loss,
    the priorities (B,))."""
    obs, actions, mask = batch["obs"], batch["actions"], batch["mask"]
    K = actions.shape[1]
    scale = int(cfg["model"]["support_scale"])
    A = int(cfg["model"]["action_space_size"])
    values = C.two_hot(C.h(batch["target_value"]), scale)
    rewards = C.two_hot(C.h(batch["target_reward"]), scale)
    policies = batch["target_policy"]
    latent, value_logits, policy_logits = M.initial_inference(p, obs[:, 0], rnd)
    value_loss = C.cross_entropy(value_logits, values[:, 0])
    policy_loss = C.cross_entropy(policy_logits, policies[:, 0])
    entropy_loss = -entropy(policy_logits)
    priority = torch.abs(C.logits_to_value(value_logits.detach(), scale)
                         - batch["target_value"][:, 0])
    reward_loss = torch.zeros_like(value_loss)
    consistency = torch.zeros_like(value_loss)
    for k in range(K):
        latent, reward_logits, value_logits, policy_logits = M.recurrent_inference(
            p, latent, actions[:, k], A, rnd)
        with torch.no_grad():
            target = project(p, M.representation(p, obs[:, k + 1], rnd), False, rnd)
        consistency = consistency + negative_cosine(project(p, latent, True, rnd), target) * mask[:, k]
        policy_loss = policy_loss + C.cross_entropy(policy_logits, policies[:, k + 1])
        value_loss = value_loss + C.cross_entropy(value_logits, values[:, k + 1])
        reward_loss = reward_loss + C.cross_entropy(reward_logits, rewards[:, k])
        entropy_loss = entropy_loss - entropy(policy_logits)
    per_row = (float(cfg["ssl_loss_weight"]) * consistency
               + float(cfg["policy_loss_weight"]) * policy_loss
               + float(cfg["value_loss_weight"]) * value_loss
               + float(cfg["reward_loss_weight"]) * reward_loss
               + float(cfg["policy_entropy_weight"]) * entropy_loss)
    total = torch.mean(batch["weights"] * per_row)
    return total / K, total.detach(), priority


def learning_rate(cfg: Dict, step: int) -> float:
    lr = float(cfg["learning_rate"])
    if not cfg.get("piecewise_decay_lr_scheduler", False):
        return lr
    t = int(cfg["threshold_training_steps_for_final_lr"])
    return lr * 0.1 ** ((step >= int(0.5 * t)) + (step >= int(0.75 * t)))


def learn_steps(weights: C.Params, cfg: Dict, batches: List[Batch], rnd: C.Rounding = C.FLOAT32
                ) -> Tuple[List[float], C.Params, C.Params, List[torch.Tensor]]:
    """len(batches) learn steps from ``weights`` (left untouched): (each
    step's logged loss, the first step's clipped gradients, the parameters'
    change over all the steps, each step's priorities)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    momentum, decay = float(cfg["momentum"]), float(cfg["weight_decay"])
    clip = float(cfg["grad_clip_value"])
    buffers: Dict[str, torch.Tensor] = {}
    losses_out, prios, first_grads = [], [], None
    for it, batch in enumerate(batches):
        loss, total, prio = losses(params, cfg, batch, rnd)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads.values()]))
        scale = torch.where(norm < clip, 1.0, clip / norm)
        grads = {k: g * scale for k, g in grads.items()}
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        lr = learning_rate(cfg, it)
        with torch.no_grad():
            for k, p in params.items():
                d = grads[k] + decay * p
                buffers[k] = d.clone() if k not in buffers else buffers[k] * momentum + d
                p.sub_(lr * buffers[k])
        losses_out.append(float(total))
        prios.append(prio)
    change = {k: (params[k].detach() - weights[k]) for k in params}
    return losses_out, first_grads, change, prios
