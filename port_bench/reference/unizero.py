"""Plain reference of UniZero's learn step (Pu et al. 2024, "UniZero:
Generalized and Efficient Planning with Scalable Latent World Models";
LightZero ``lzero/model/unizero_world_models/world_model.py``, ``policy/
unizero.py``).

One step: every observation of the (B, K + 1) unroll is encoded (the conv
DownSample ResNet, a Linear to the embedding width, SimNorm), interleaved
with the K action embeddings as o_0, a_0, ..., o_K and passed through a
causal pre-norm transformer (RoPE on queries and keys, GELU MLP, a final
LayerNorm). Value and policy heads read the observation positions, the
reward head and the next-latent head (then SimNorm) the action positions.
The loss per row is the policy, 0.25 x value and reward cross-entropies
against two-hot targets of h(x) on the support, 10 x the masked MSE of the
predicted next latents against the encoder's own (without their gradient),
and the adaptive-temperature entropy bonus of the first step's policy; the
importance-weighted mean plus alpha's loss, divided by K, is the loss
whose gradient AdamW follows: global-norm clipping at 10 of the model's
gradients, decoupled decay 1e-4 on the tensors of rank >= 2 only, and
log alpha in an Adam group of its own at 1e-3, clamped to
[log 0.05, log 10] after the step.

Departures from the published description, all of which the program under
test makes too (they are the semantics the benchmark holds it to):

- LayerNorm (eps 1e-6) for BatchNorm in the encoder, no conv biases, SAME
  padding as XLA pads (the JAX package's flax modules).
- The pyramid pools twice at every frame size, so a 64x64 frame gives a
  4x4 latent; LightZero's ``DownSample`` leaves out its last pool for
  64-pixel frames (an 8x8 latent, 4,096 inputs to the embedding's Linear).
- RoPE rotates split halves of each head (not interleaved pairs); the
  attention is a plain softmax over the causal mask; ``gelu`` is the tanh
  approximation.
- The observation loss's target is the online encoder's own embedding
  without its gradient (LightZero's default keeps no separate target
  encoder for it either); the entropy bonus reads the first step's policy
  only, and alpha's target entropy is annealed from 0.98 to 0.05 of
  log(A) over 1e5 steps.
- A step with a non-finite loss or gradient is skipped (not reached here:
  the benchmark's steps are finite).

``rnd`` is the format of every conv and matmul operand (``common.FLOAT32``
or ``common.TF32``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F

from port_bench.reference import common as C

Batch = Dict[str, torch.Tensor]


def encode(p: C.Params, frames: torch.Tensor, rnd: C.Rounding) -> torch.Tensor:
    """(n, H, W, c) frames -> (n, D) SimNorm embeddings."""
    x = C.downsample(frames, p, "encoder_conv.downsample", rnd)
    i = 0
    while f"encoder_conv.res.{i}.conv.0.weight" in p:
        x = C.res_block(x, p, f"encoder_conv.res.{i}", rnd)
        i += 1
    x = C.linear(x.reshape(x.shape[0], -1), p["encoder_proj.weight"], p["encoder_proj.bias"], rnd)
    return C.sim_norm(x)


def _rope(x: torch.Tensor, pos: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of split halves; x (B, H, T, Dh), pos (T,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (base ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = pos[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def transformer(p: C.Params, x: torch.Tensor, heads: int, rnd: C.Rounding) -> torch.Tensor:
    B, T, D = x.shape
    dh = D // heads
    pos = torch.arange(T, device=x.device)
    causal = torch.where(pos[:, None] >= pos[None, :], 0.0, float("-inf"))
    i = 0
    while f"transformer.blocks.{i}.attn.qkv.weight" in p:
        b = f"transformer.blocks.{i}"
        y = C.layer_norm(x, p, f"{b}.norm.0")
        qkv = C.linear(y, p[f"{b}.attn.qkv.weight"], None, rnd).reshape(B, T, 3, heads, dh)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        q, k = _rope(q, pos), _rope(k, pos)
        att = torch.matmul(rnd(q), rnd(k).transpose(-1, -2)) / math.sqrt(dh) + causal
        att = torch.softmax(att, dim=-1)
        y = torch.matmul(rnd(att), rnd(v)).transpose(1, 2).reshape(B, T, D)
        x = x + C.linear(y, p[f"{b}.attn.out_proj.weight"], None, rnd)
        y = C.layer_norm(x, p, f"{b}.norm.1")
        y = C.linear(y, p[f"{b}.ff_up.weight"], p[f"{b}.ff_up.bias"], rnd)
        y = C.linear(F.gelu(y, approximate="tanh"), p[f"{b}.ff_down.weight"],
                     p[f"{b}.ff_down.bias"], rnd)
        x = x + y
        i += 1
    return C.layer_norm(x, p, "transformer.norm.0")


def losses(p: C.Params, cfg: Dict, batch: Batch, train_iter: int, rnd: C.Rounding):
    """(the loss whose gradient the step follows, the logged total loss,
    the priorities (B,))."""
    obs, actions = batch["obs"], batch["actions"]
    B, K1 = obs.shape[:2]
    K = K1 - 1
    scale = int(cfg["model"]["support_scale"])
    A = int(cfg["model"]["action_space_size"])
    emb = encode(p, obs.reshape(B * K1, *obs.shape[2:]), rnd).reshape(B, K1, -1)
    D = emb.shape[-1]
    tokens = torch.zeros((B, 2 * K + 1, D), device=obs.device)
    tokens[:, 0::2] = emb
    tokens[:, 1::2] = p["action_embed.weight"][actions.long()]
    x = transformer(p, tokens, int(cfg["model"]["num_heads"]), rnd)
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
    progress = min(1.0, float(train_iter) / float(cfg["target_entropy_decay_steps"]))
    ratio = (float(cfg["target_entropy_start_ratio"]) * (1.0 - progress)
             + float(cfg["target_entropy_end_ratio"]) * progress)
    alpha_loss = p["log_alpha"] * (entropy.mean() - math.log(A) * ratio).detach()
    per_row = (float(cfg["policy_loss_weight"]) * policy_loss
               + float(cfg["value_loss_weight"]) * value_loss
               + float(cfg["reward_loss_weight"]) * reward_loss
               + float(cfg["obs_loss_weight"]) * obs_loss
               - torch.exp(p["log_alpha"]).detach() * entropy)
    total = torch.mean(batch["weights"] * per_row) + alpha_loss
    priority = torch.abs(C.logits_to_value(value_logits[:, 0].detach(), scale)
                         - batch["target_value"][:, 0])
    return total / K, total.detach(), priority


class AdamW:
    """torch.optim.AdamW's update, written out: (lr, decay) per leaf."""

    def __init__(self, params: C.Params, cfg: Dict):
        lr, wd = float(cfg["learning_rate"]), float(cfg["weight_decay"])
        alpha_lr = float(cfg["adaptive_entropy_alpha_lr"])
        self.hyper = {k: ((alpha_lr, 0.0) if k == "log_alpha" else (lr, wd if v.ndim >= 2 else 0.0))
                      for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: C.Params, grads: C.Params, b1=0.9, b2=0.999, eps=1e-8) -> None:
        self.t += 1
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in params.items():
            lr, wd = self.hyper[k]
            g = grads[k]
            p.mul_(1.0 - lr * wd)
            self.m[k].lerp_(g, 1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + eps
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def learn_steps(weights: C.Params, cfg: Dict, batches: List[Batch], rnd: C.Rounding = C.FLOAT32
                ) -> Tuple[List[float], C.Params, C.Params, List[torch.Tensor]]:
    """len(batches) learn steps from ``weights`` (left untouched): (each
    step's logged loss, the first step's clipped gradients, the parameters'
    change over all the steps, each step's priorities)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    opt = AdamW(params, cfg)
    clip = float(cfg["grad_clip_value"])
    losses_out, prios, first_grads = [], [], None
    for it, batch in enumerate(batches):
        loss, total, prio = losses(params, cfg, batch, it, rnd)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
        model = [k for k in params if k != "log_alpha"]
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
        losses_out.append(float(total))
        prios.append(prio)
    change = {k: (params[k].detach() - weights[k]) for k in params}
    return losses_out, first_grads, change, prios
