"""Plain reference of ScaleZero's multitask learn step: the UniZero world
model with a mixture-of-experts feed-forward in every block, learned on
several tasks at once (ScaleZero, arXiv:2509.07945; LightZero
``zoo/atari/config/atari_unizero_multitask_segment_ddp_config.py``,
``lzero/model/unizero_world_models/moe.py``).

The block, for tokens x:

    x = x + Attn(LN1(x))                         (reference/unizero.py's)
    h = LN2(x);  g = h Wg                        (E logits, no bias)
    S = {e : g_e >= the k-th largest of g}       (ties keep every tied expert)
    w_e = softmax of g over S, 0 outside S
    x = x + sum_e w_e SwiGLU_e(h) + SwiGLU_shared(h)
    SwiGLU(h) = (SiLU(h W1) * (h W3)) W2         (4 D wide, no bias)

Each expert is applied to every token and weighed by w_e, 0 for the
experts outside S: the sum as written. With k = 1, w = 1 on the selected
expert, so the gate gets no gradient, as in LightZero. The shared expert
(DeepSeekMoE, arXiv:2401.06066) sees every token and is added unweighted.

Every token carries its row's task embedding, added before the first
block. The loss is ``task_loss_vector``'s: per task, the mean over its rows
of the importance-weighted per-row UniZero losses (reference/unizero.py's
terms), then the task-weighted mean over the tasks present, plus alpha's
loss, over K. The encoder, the attention, the heads, the per-row terms and
AdamW are reference/unizero.py's, with the departures listed there.

Routings that rounding decides. A token whose two competing logits (the
k-th and the (k+1)-th largest) lie closer than ``PIN_MARGIN`` can go to
either expert under another order of float32 sums, and the two experts'
outputs differ by far more than rounding. Given the program's own logits
(``pins``: per step, per layer, (rows x tokens, E)), such a token takes the
program's selection; every other token takes the reference's own. Each
step's tally counts the pinned token-layers, those where the pin changed
the selection, the smallest margin met and the largest gap between the
reference's logits and the program's.

The rows run in blocks of ``rows`` (all at once by default): the loss is a
sum over rows once the task counts and the batch's mean entropy are known,
so each block's gradient adds up to the batch's. ``rnd`` is the format of
every conv and matmul operand (``common.FLOAT32`` or ``common.TF32``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.nn import functional as F

from port_bench.reference import common as C
from port_bench.reference import unizero as U

Batch = Dict[str, torch.Tensor]
# a batch's keys with one entry a row (``task_weights`` has one a task)
ROW_KEYS = ("obs", "actions", "mask", "target_reward", "target_value", "target_policy", "weights",
            "task_id")
# logits closer than this can swap order on rounding (PERF.md gives the
# readings it was set from)
PIN_MARGIN = 1e-2


def swiglu(p: C.Params, name: str, h: torch.Tensor, rnd: C.Rounding) -> torch.Tensor:
    a = C.linear(h, p[f"{name}.dense.0.weight"], None, rnd)
    b = C.linear(h, p[f"{name}.dense.1.weight"], None, rnd)
    return C.linear(F.silu(a) * b, p[f"{name}.dense.2.weight"], None, rnd)


def moe(p: C.Params, name: str, h: torch.Tensor, k: int, rnd: C.Rounding,
        pin: Optional[torch.Tensor], tally: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The block's feed-forward of tokens h (N, D); ``pin`` the program's
    logits of the same tokens (N, E) or None."""
    g = C.linear(h, p[f"{name}.gate.weight"], None, rnd)
    E = g.shape[-1]
    top = torch.sort(g, dim=-1, descending=True).values
    chosen = g >= top[:, k - 1:k]
    if k < E:
        margin = (top[:, k - 1] - top[:, k]).detach()
        tally["smallest_margin"] = torch.minimum(tally["smallest_margin"], margin.min())
        if pin is not None:
            near = margin < PIN_MARGIN
            theirs = pin >= torch.sort(pin, dim=-1, descending=True).values[:, k - 1:k]
            tally["logit_gap"] = torch.maximum(tally["logit_gap"], (g.detach() - pin).abs().max())
            tally["pinned"] += near.sum()
            tally["changed"] += (near & (theirs != chosen).any(dim=-1)).sum()
            chosen = torch.where(near[:, None], theirs, chosen)
    w = torch.softmax(torch.where(chosen, g, float("-inf")), dim=-1)
    out = sum(w[:, e:e + 1] * swiglu(p, f"{name}.experts.{e}", h, rnd) for e in range(E))
    if f"{name}.shared.dense.0.weight" in p:
        out = out + swiglu(p, f"{name}.shared", h, rnd)
    return out


def transformer(p: C.Params, x: torch.Tensor, heads: int, k: int, rnd: C.Rounding,
                pins: Optional[List[torch.Tensor]], tally: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """reference/unizero.py's causal pre-norm transformer with the MoE
    feed-forward; ``pins`` one (B T, E) tensor a layer, or None."""
    B, T, D = x.shape
    dh = D // heads
    pos = torch.arange(T, device=x.device)
    causal = torch.where(pos[:, None] >= pos[None, :], 0.0, float("-inf"))
    i = 0
    while f"transformer.blocks.{i}.attn.qkv.weight" in p:
        b = f"transformer.blocks.{i}"
        y = C.layer_norm(x, p, f"{b}.norm.0")
        qkv = C.linear(y, p[f"{b}.attn.qkv.weight"], None, rnd).reshape(B, T, 3, heads, dh)
        q, kk, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        q, kk = U._rope(q, pos), U._rope(kk, pos)
        att = torch.matmul(rnd(q), rnd(kk).transpose(-1, -2)) / math.sqrt(dh) + causal
        att = torch.softmax(att, dim=-1)
        y = torch.matmul(rnd(att), rnd(v)).transpose(1, 2).reshape(B, T, D)
        x = x + C.linear(y, p[f"{b}.attn.out_proj.weight"], None, rnd)
        y = C.layer_norm(x, p, f"{b}.norm.1").reshape(B * T, D)
        x = x + moe(p, f"{b}.moe", y, k, rnd, None if pins is None else pins[i],
                    tally).reshape(B, T, D)
        i += 1
    return C.layer_norm(x, p, "transformer.norm.0")


def row_terms(p: C.Params, cfg: Dict, batch: Batch, train_iter: int, rnd: C.Rounding,
              pins: Optional[List[torch.Tensor]], tally: Dict[str, torch.Tensor]):
    """(each row's loss before importance weighting (B,), each row's
    first-step policy entropy (B,), the priorities (B,)) of the rows of
    ``batch``."""
    obs, actions = batch["obs"], batch["actions"]
    B, K1 = obs.shape[:2]
    K = K1 - 1
    m = cfg["model"]
    scale, A = int(m["support_scale"]), int(m["action_space_size"])
    emb = U.encode(p, obs.reshape(B * K1, *obs.shape[2:]), rnd).reshape(B, K1, -1)
    D = emb.shape[-1]
    tokens = torch.zeros((B, 2 * K + 1, D), device=obs.device)
    tokens[:, 0::2] = emb
    tokens[:, 1::2] = p["action_embed.weight"][actions.long()]
    tokens = tokens + p["transformer.task_embed.weight"][batch["task_id"].long()][:, None, :]
    x = transformer(p, tokens, int(m["num_heads"]), int(m["num_experts_per_tok"]), rnd, pins,
                    tally)
    obs_pos, act_pos = x[:, 0::2], x[:, 1::2]
    value_logits = C.mlp(obs_pos, p, "value_head", 1, rnd)
    policy_logits = C.mlp(obs_pos, p, "policy_head", 1, rnd)
    reward_logits = C.mlp(act_pos, p, "reward_head", 1, rnd)
    obs_pred = C.sim_norm(C.mlp(act_pos, p, "obs_head", 1, rnd))

    value_loss = C.cross_entropy(value_logits, C.two_hot(C.h(batch["target_value"]), scale)).sum(-1)
    policy_loss = C.cross_entropy(policy_logits, batch["target_policy"]).sum(-1)
    reward_loss = C.cross_entropy(reward_logits, C.two_hot(C.h(batch["target_reward"]), scale)).sum(-1)
    obs_loss = torch.sum(torch.mean((obs_pred - emb[:, 1:].detach()) ** 2, dim=-1) * batch["mask"],
                         dim=-1)
    prob = torch.softmax(policy_logits[:, 0], dim=-1)
    entropy = -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-9)), dim=-1)
    per_row = (float(cfg["policy_loss_weight"]) * policy_loss
               + float(cfg["value_loss_weight"]) * value_loss
               + float(cfg["reward_loss_weight"]) * reward_loss
               + float(cfg["obs_loss_weight"]) * obs_loss
               - torch.exp(p["log_alpha"]).detach() * entropy)
    priority = torch.abs(C.logits_to_value(value_logits[:, 0].detach(), scale)
                         - batch["target_value"][:, 0])
    return per_row, entropy, priority


def new_tally(device) -> Dict[str, torch.Tensor]:
    return dict(pinned=torch.zeros((), dtype=torch.long, device=device),
                changed=torch.zeros((), dtype=torch.long, device=device),
                smallest_margin=torch.full((), math.inf, device=device),
                logit_gap=torch.zeros((), device=device))


def step_grads(params: C.Params, cfg: Dict, batch: Batch, train_iter: int, rnd: C.Rounding,
               pins: Optional[List[torch.Tensor]], rows: int, tally: Dict[str, torch.Tensor]
               ) -> Tuple[C.Params, float, torch.Tensor]:
    """(the gradient of the step's loss, its logged total, the priorities),
    the rows taken ``rows`` at a time."""
    B, T = batch["actions"].shape[0], 2 * batch["actions"].shape[1] + 1
    tasks = int(cfg["task_num"])
    task_id = batch["task_id"].long()
    n = torch.bincount(task_id, minlength=tasks).to(torch.float32)
    present = (n > 0).to(torch.float32)
    # each row's share of the loss: its task's weight over the tasks present,
    # over its task's rows
    share = (batch["task_weights"] / torch.clamp(present.sum(), min=1.0)
             / torch.clamp(n, min=1.0))[task_id] * batch["weights"]
    K = batch["actions"].shape[1]
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    total, entropies, prios = 0.0, [], []
    for r0 in range(0, B, rows):
        part = {k: batch[k][r0:r0 + rows] for k in ROW_KEYS}
        sub = None if pins is None else [g[r0 * T:(r0 + rows) * T] for g in pins]
        per_row, entropy, prio = row_terms(params, cfg, part, train_iter, rnd, sub, tally)
        loss = torch.sum(share[r0:r0 + rows] * per_row)
        for k, g in zip(params, torch.autograd.grad(loss / K, list(params.values()),
                                                    allow_unused=True)):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
        entropies.append(entropy.detach())
        prios.append(prio)
    A = int(cfg["model"]["action_space_size"])
    progress = min(1.0, float(train_iter) / float(cfg["target_entropy_decay_steps"]))
    ratio = (float(cfg["target_entropy_start_ratio"]) * (1.0 - progress)
             + float(cfg["target_entropy_end_ratio"]) * progress)
    alpha_loss = params["log_alpha"] * (torch.cat(entropies).mean() - math.log(A) * ratio)
    grads["log_alpha"] += torch.autograd.grad(alpha_loss / K, params["log_alpha"])[0]
    return grads, total + float(alpha_loss.detach()), torch.cat(prios)


def learn_steps(weights: C.Params, cfg: Dict, batches: List[Batch], rnd: C.Rounding = C.FLOAT32,
                pins: Optional[List[List[torch.Tensor]]] = None, rows: Optional[int] = None
                ) -> Tuple[List[float], C.Params, C.Params, List[torch.Tensor], List[dict]]:
    """len(batches) learn steps from ``weights`` (left untouched): (each
    step's logged loss, the first step's clipped gradients, the parameters'
    change over all the steps, each step's priorities, each step's tally of
    the routings). ``pins``: per step, the program's gate logits a layer."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    opt = U.AdamW(params, cfg)
    clip = float(cfg["grad_clip_value"])
    model = [k for k in params if k != "log_alpha"]
    losses_out, prios, tallies, first_grads = [], [], [], None
    for it, batch in enumerate(batches):
        tally = new_tally(batch["obs"].device)
        grads, total, prio = step_grads(params, cfg, batch, it, rnd,
                                        None if pins is None or it >= len(pins) else pins[it],
                                        rows or batch["obs"].shape[0], tally)
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(grads[k])
                                                     for k in model]))
        scale = torch.where(norm < clip, 1.0, clip / norm)
        for k in model:
            grads[k] = grads[k] * scale
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        with torch.no_grad():
            params["log_alpha"].clamp_(math.log(5e-2), math.log(10.0))
        losses_out.append(total)
        prios.append(prio)
        tallies.append({k: v.item() for k, v in tally.items()})
    change = {k: (params[k].detach() - weights[k]) for k in params}
    return losses_out, first_grads, change, prios, tallies
