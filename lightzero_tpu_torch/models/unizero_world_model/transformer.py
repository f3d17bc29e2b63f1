"""Decoder-only transformer of the UniZero world model
(``lightzero_tpu/models/unizero_world_model/transformer.py``).

Tokens carry an absolute position each (RoPE, split halves rotated as the
JAX ``_rope`` does, not interleaved pairs). Without a cache the forward is
one causal pass over the sequence (training); with a ``KVCache`` the new
tokens attend over the cache's ring buffer and themselves, optionally only
to the last ``context_window`` positions, and their keys and values are
written into the ring at slot ``pos % max_tokens`` (search and collection).

Attention is what the JAX module computes: matmul, mask, softmax, matmul, in
plain torch ops. The JAX package computes it with jnp outside any Pallas
kernel, so there is no TPU kernel here to port.

Deliberate differences from the JAX module:

- A query row that sees no key (a prefill token at position -1, masked out
  as history the row does not have) gives a zero output. The JAX softmax of
  an all ``-inf`` row is NaN, and the next layer's ``att @ v`` carries that
  NaN into every row (0 * NaN), so a short history's prefill is NaN there
  (ROADMAP queue 3). Rows that see a key are unchanged.
- The ring-buffer write drops ``pos < 0`` tokens with an explicit mask where
  the JAX write sends them to slot ``Tc``, out of bounds, and relies on XLA
  dropping the scatter. When one write holds more tokens than the ring has
  slots, the tokens are written in order, so the latest position holds each
  slot; XLA leaves the order of a scatter's duplicate indices unspecified.

Attention maps: the JAX module sows each layer's softmaxed attention of
the full-sequence (training) forward into flax's "intermediates"
collection. Here ``capture_attention(module)`` turns on the same capture
for the block it wraps: each ``SelfAttention`` under ``module`` appends its
(B, H, T, T) attention, detached, to the list the context yields, layer by
layer in call order. Off (the default) it costs one attribute test a layer.

Other flax behaviour kept: ``nn.gelu`` is the tanh approximation; LayerNorms
use eps 1e-6; Dense kernels (in, out) become Linear weights (out, in) in
``utils/params_import.py``, while the LoRA factors keep flax's orientation.
Module names follow flax's (``blocks.i`` for ``Block_i``, ``norm.i`` for
``LayerNorm_i``) so that the parameter map is mechanical.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from lightzero_tpu_torch.models.common import LAYER_NORM_EPS, lecun_normal_


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """(the JAX ``TransformerConfig``)."""

    num_layers: int = 2
    num_heads: int = 8
    embed_dim: int = 256
    max_tokens: int = 32  # ring-buffer capacity (2 * context steps)
    rope_base: float = 10000.0
    # sliding window of the incremental attention, in tokens; 0 = the ring
    context_window: int = 0
    moe_in_transformer: bool = False
    num_experts: int = 4
    num_experts_per_tok: int = 1
    # SwiGLUs beside the routed experts that every token passes through (0
    # or 1; the JAX config has none)
    n_shared_experts: int = 0
    # a learned per-task embedding added to every token (multitask)
    num_tasks: int = 0
    # CurriculumLoRA: adapters of rank lora_r for stages 1..stage_num-1
    lora_r: int = 0
    curriculum_stage_num: int = 1
    curriculum_stage: int = 0
    lora_alpha: float = 1.0
    lora_scale_init: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


class KVCache(NamedTuple):
    """Fixed-shape ring-buffer cache: k, v (B, L, H, Tc, Dh); pos (B, Tc) the
    absolute position of each slot (-1 = empty); next_pos (B,) the position
    of the next token. The search keeps one per tree node."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    next_pos: torch.Tensor


def init_kv_cache(cfg: TransformerConfig, batch_size: int, device=None,
                  dtype: torch.dtype = torch.float32) -> KVCache:
    B, L, H, T, Dh = batch_size, cfg.num_layers, cfg.num_heads, cfg.max_tokens, cfg.head_dim
    return KVCache(
        k=torch.zeros((B, L, H, T, Dh), dtype=dtype, device=device),
        v=torch.zeros((B, L, H, T, Dh), dtype=dtype, device=device),
        pos=torch.full((B, T), -1, dtype=torch.long, device=device),
        next_pos=torch.zeros((B,), dtype=torch.long, device=device),
    )


def _rope_tables(pos: torch.Tensor, head_dim: int, base: float):
    """(cos, sin) of the rotation angles pos * base^(-i / half), (..., T, half)."""
    half = head_dim // 2
    freqs = 1.0 / (base ** (torch.arange(half, dtype=torch.float32, device=pos.device) / half))
    angles = pos[..., None].to(torch.float32) * freqs
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of split halves with the tables of ``_rope_tables``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _linear(in_dim: int, out_dim: int, bias: bool, generator) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim, bias=bias)
    lecun_normal_(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class CurriculumLoRADense(nn.Module):
    """Dense layer with curriculum-staged LoRA adapters (flax
    ``CurriculumLoRADense``):

        y = (1 + 0.2 tanh(base_scale)) base(x)
            + sum_{j=1..stage} (init + 0.2 tanh(adapter_scale_j)) (x A_j) B_j alpha / r

    Every adapter exists at every stage; ``stage`` only switches them on, and
    ``curriculum_trainable_mask`` says which parameters train."""

    def __init__(self, in_dim: int, features: int, cfg: TransformerConfig, use_bias: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.stage = cfg.curriculum_stage
        self.base = _linear(in_dim, features, use_bias, generator)
        self.base_scale = nn.Parameter(torch.zeros(()))
        r = cfg.lora_r
        for j in range(1, cfg.curriculum_stage_num):
            a = torch.empty(in_dim, r)
            with torch.no_grad():
                a.normal_(0.0, 0.01, generator=generator)
            self.register_parameter(f"lora_A_{j}", nn.Parameter(a))
            self.register_parameter(f"lora_B_{j}", nn.Parameter(torch.zeros(r, features)))
            self.register_parameter(f"adapter_scale_{j}", nn.Parameter(torch.zeros(())))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        y = (1.0 + 0.2 * torch.tanh(self.base_scale)) * self.base(x)
        scaling = cfg.lora_alpha / max(cfg.lora_r, 1)
        for j in range(1, cfg.curriculum_stage_num):
            if j > self.stage:
                continue
            alpha_j = cfg.lora_scale_init + 0.2 * torch.tanh(getattr(self, f"adapter_scale_{j}"))
            a, b = getattr(self, f"lora_A_{j}"), getattr(self, f"lora_B_{j}")
            y = y + alpha_j * ((x @ a) @ b) * scaling
        return y


def _dense(cfg: TransformerConfig, in_dim: int, features: int, use_bias: bool,
           generator) -> nn.Module:
    """A Linear, or its curriculum-LoRA wrapper when LoRA is on."""
    if cfg.lora_r > 0 and cfg.curriculum_stage_num > 1:
        return CurriculumLoRADense(in_dim, features, cfg, use_bias, generator)
    return _linear(in_dim, features, use_bias, generator)


_LORA_LEAF = re.compile(r"(lora_A_|lora_B_|adapter_scale_)\d+")


def curriculum_trainable_mask(names: List[str], stage: int) -> Dict[str, bool]:
    """Which parameters (by their port name) train at a curriculum stage:
    stage 0 trains everything but the LoRA leaves; stage s >= 1 trains
    adapter s, every ``base_scale`` and the scales of earlier adapters, and
    freezes the rest of the transformer while the encoder and heads train
    (flax ``curriculum_trainable_mask``, over the port's names)."""

    def trainable(name: str) -> bool:
        parts = name.split(".")
        is_lora = any(_LORA_LEAF.fullmatch(p) or p == "base_scale" for p in parts)
        if stage == 0:
            return not is_lora
        for p in parts:
            m = re.fullmatch(r"lora_[AB]_(\d+)", p)
            if m:
                return int(m.group(1)) == stage
            m = re.fullmatch(r"adapter_scale_(\d+)", p)
            if m:
                return int(m.group(1)) < stage
            if p == "base_scale":
                return True
        return not any(p in ("transformer", "blocks") for p in parts)

    return {n: trainable(n) for n in names}


def attention_mask(cfg: TransformerConfig, pos: torch.Tensor,
                   cache: Optional[KVCache]) -> Tuple[torch.Tensor, torch.Tensor]:
    """What every layer's attention of one call masks, built once: (an
    additive mask, 0 or -inf, (B, 1, T, keys); 1.0 for the query rows that
    keep a key, 0.0 for those that keep none, (B, 1, T, 1)). Causal over the
    sequence without a cache; with one, over the ring's filled slots and the
    new tokens, within ``context_window`` of the query when it is set."""
    qpos = pos[:, None, :, None]
    if cache is None:
        keep = qpos >= pos[:, None, None, :]
    else:
        kpos = torch.cat([cache.pos, pos], dim=1)[:, None, None, :]  # (B, 1, 1, Tc+T)
        keep = (kpos >= 0) & (qpos >= kpos)
        if cfg.context_window > 0:
            keep = keep & (kpos > qpos - cfg.context_window)
    nonempty = keep.any(dim=-1, keepdim=True)
    # a row that keeps no key attends uniformly, and its output is zeroed
    bias = torch.where(keep | ~nonempty, 0.0, float("-inf"))
    return bias, nonempty.to(torch.float32)


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, layer_idx: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.layer_idx = cfg, layer_idx
        D = cfg.embed_dim
        self.qkv = _dense(cfg, D, 3 * D, False, generator)
        self.out_proj = _dense(cfg, D, D, False, generator)
        self.captured: Optional[List[torch.Tensor]] = None  # see capture_attention

    def forward(self, x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor],
                mask: Tuple[torch.Tensor, torch.Tensor], cache: Optional[KVCache] = None):
        """x (B, T, D); ``rope`` the (cos, sin) tables (B, T, 1, 1, Dh / 2) and
        ``mask`` the masks of ``attention_mask`` -> (output (B, T, D), the new
        tokens' (k, v) (B, H, T, Dh) with a cache, else None). A query row
        that keeps no key gives zeros (the JAX softmax gives NaN there)."""
        cfg = self.cfg
        B, T, D = x.shape
        H, Dh = cfg.num_heads, cfg.head_dim
        qkv = self.qkv(x).reshape(B, T, 3, H, Dh)
        qk = _rotate(qkv[:, :, :2], *rope)  # RoPE on q and k together
        q, k, v = qk[:, :, 0].transpose(1, 2), qk[:, :, 1].transpose(1, 2), qkv[:, :, 2].transpose(1, 2)
        new_kv = None
        if cache is not None:
            new_kv = (k, v)
            k = torch.cat([cache.k[:, self.layer_idx], k], dim=2)
            v = torch.cat([cache.v[:, self.layer_idx], v], dim=2)
        bias, nonempty = mask
        att = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(Dh) + bias
        att = torch.softmax(att, dim=-1) * nonempty
        if self.captured is not None and cache is None:
            self.captured.append(att.detach())
        y = torch.einsum("bhqk,bhkd->bhqd", att, v).transpose(1, 2).reshape(B, T, D)
        return self.out_proj(y), new_kv


@contextlib.contextmanager
def capture_attention(module: nn.Module) -> Iterator[List[torch.Tensor]]:
    """Within the block, every full-sequence forward of a ``SelfAttention``
    under ``module`` appends its softmaxed (B, H, T, T) attention to the
    yielded list (flax's ``sow("intermediates", "attention", att)``)."""
    layers = [m for m in module.modules() if isinstance(m, SelfAttention)]
    captured: List[torch.Tensor] = []
    for layer in layers:
        layer.captured = captured
    try:
        yield captured
    finally:
        for layer in layers:
            layer.captured = None


class Block(nn.Module):
    """Pre-norm block: attention, then the GELU MLP (``ff_up``, ``ff_down``)
    or the MoE (``moe``)."""

    def __init__(self, cfg: TransformerConfig, layer_idx: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D = cfg.embed_dim
        self.cfg = cfg
        self.norm = nn.ModuleList(nn.LayerNorm(D, eps=LAYER_NORM_EPS) for _ in range(2))
        self.attn = SelfAttention(cfg, layer_idx, generator)
        if cfg.moe_in_transformer:
            from lightzero_tpu_torch.models.unizero_world_model.moe import MoELayer

            self.moe = MoELayer(D, cfg.num_experts, cfg.num_experts_per_tok,
                                cfg.n_shared_experts, generator)
        else:
            self.ff_up = _dense(cfg, D, 4 * D, True, generator)
            self.ff_down = _dense(cfg, 4 * D, D, True, generator)

    def forward(self, x, rope, mask, cache=None):
        attn_out, new_kv = self.attn(self.norm[0](x), rope, mask, cache)
        x = x + attn_out
        h = self.norm[1](x)
        if self.cfg.moe_in_transformer:
            h = self.moe(h)
        else:
            h = self.ff_down(F.gelu(self.ff_up(h), approximate="tanh"))
        return x + h, new_kv


def write_ring(cache: KVCache, new_k: torch.Tensor, new_v: torch.Tensor,
               pos: torch.Tensor) -> KVCache:
    """The cache with the T new tokens' keys and values (B, L, H, T, Dh)
    written at slots pos % Tc. Tokens at pos < 0 are masked out; the tokens
    are written in order, so the latest holds a slot that two of them
    share. ``next_pos`` becomes the last token's position + 1."""
    Tc = cache.k.shape[3]
    k, v, cpos = cache.k, cache.v, cache.pos
    slot_ids = torch.arange(Tc, device=pos.device)
    for t in range(pos.shape[1]):
        p = pos[:, t]
        write = (slot_ids[None, :] == torch.remainder(p, Tc)[:, None]) & (p >= 0)[:, None]
        m = write[:, None, None, :, None]
        k = torch.where(m, new_k[:, :, :, t:t + 1], k)
        v = torch.where(m, new_v[:, :, :, t:t + 1], v)
        cpos = torch.where(write, p[:, None], cpos)
    return KVCache(k=k, v=v, pos=cpos, next_pos=pos[:, -1] + 1)


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        if cfg.num_tasks > 0:
            self.task_embed = nn.Embedding(cfg.num_tasks, D)
            with torch.no_grad():
                self.task_embed.weight.normal_(0.0, 1.0 / math.sqrt(D), generator=generator)
        self.blocks = nn.ModuleList(Block(cfg, i, generator) for i in range(cfg.num_layers))
        self.norm = nn.ModuleList([nn.LayerNorm(D, eps=LAYER_NORM_EPS)])

    def forward(self, x: torch.Tensor, pos: torch.Tensor, cache: Optional[KVCache] = None,
                task_id: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """x (B, T, D), pos (B, T). With ``cache``: attends over the cache and
        x and returns the cache with x's keys and values written in."""
        if self.cfg.num_tasks > 0:
            tid = (torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)
                   if task_id is None else task_id.long())
            x = x + self.task_embed(tid)[:, None, :]
        cos, sin = _rope_tables(pos, self.cfg.head_dim, self.cfg.rope_base)
        rope = (cos[:, :, None, None, :], sin[:, :, None, None, :])
        mask = attention_mask(self.cfg, pos, cache)
        new_ks, new_vs = [], []
        for blk in self.blocks:
            x, new_kv = blk(x, rope, mask, cache)
            if new_kv is not None:
                new_ks.append(new_kv[0])
                new_vs.append(new_kv[1])
        x = self.norm[0](x)
        if cache is None:
            return x, None
        return x, write_ring(cache, torch.stack(new_ks, dim=1), torch.stack(new_vs, dim=1), pos)
