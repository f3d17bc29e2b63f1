"""The seeded searches that the backup kernel is held to its plain version
on, by tests/test_torch_fused_backup.py on the CPU and the card and by
chip_smoke.py's phase 3.

``CHECK_SEARCHES`` lists them as (name, B, A, simulations, embedding row
shape, search kind): the search cell's shape (conv MuZero's 6x6x64 latent
at 2,048 roots), a CartPole-sized batch whose leaves are often terminal,
the Atari action set, more actions than a warp has lanes, and one search
for each of the kernel's options. ``check_search`` builds one of them on a
device; ``check_recurrent_fn`` is their stand-in model. The search modules
do not import this one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lightzero_tpu_torch.search.gumbel import GumbelSearchConfig, batch_gumbel_search
from lightzero_tpu_torch.search.puct import batch_puct_search
from lightzero_tpu_torch.search.types import RecurrentOutput, RootOutput, SearchConfig

CHECK_SEARCHES = [
    ("cell", 2048, 6, 50, (6, 6, 64), "puct"),
    ("terminal_stops", 3, 2, 25, (4,), "terminal"),
    ("a18", 64, 18, 30, (8,), "puct"),
    ("a37", 16, 37, 20, (8,), "legal"),
    ("prior_is_logits", 32, 6, 20, (8,), "gumbel"),
    ("value_override", 32, 6, 20, (8,), "reuse"),
    ("is_chance", 32, 6, 20, (8,), "chance"),
]


def check_recurrent_fn(A: int, kind: str = "puct"):
    """A stand-in model for the checks: deterministic elementwise maps and
    means of the parent's embedding (one tensor of any row shape), so that
    two runs of a search on one device see the same outputs. ``kind``
    'terminal' marks leaves terminal, 'legal' and 'chance' give legal masks
    with illegal actions, 'chance' also marks chance nodes."""

    def recurrent_fn(action: torch.Tensor, emb: torch.Tensor) -> RecurrentOutput:
        a = action.to(emb.dtype).reshape((-1,) + (1,) * (emb.dim() - 1))
        new = torch.tanh(emb * 0.9 + a * 0.13 + 0.05)
        flat = new.reshape(new.shape[0], -1)
        s = flat.mean(dim=1)
        t = flat[:, : max(1, flat.shape[1] // 2)].mean(dim=1)
        actions = torch.arange(1, A + 1, device=emb.device, dtype=emb.dtype)
        logits = 2.0 * torch.sin((7.0 * s + 3.0 * t)[:, None] * actions + t[:, None])
        value = torch.tanh(4.0 * s + t)
        out = RecurrentOutput(reward=0.1 * torch.cos(3.0 * t + s), value=value,
                              prior_logits=logits, embedding=new)
        if kind == "terminal":
            out = out._replace(terminal=value > 0.3)
        if kind in ("legal", "chance"):
            legal = torch.cos(logits * 3.0) > -0.5
            legal[:, 0] = True
            out = out._replace(legal_mask=legal)
        if kind == "chance":
            out = out._replace(is_chance=value < 0.0)
        return out

    return recurrent_fn


def check_search(name: str, device, seed: int = 0, B: Optional[int] = None):
    """The CHECK_SEARCHES entry ``name`` from roots drawn from ``seed`` (``B``
    cuts the batch): ``(search, args, kwargs)`` with every input already on
    ``device``; ``search(*args, **kwargs)`` runs it."""
    _, B0, A, sims, row, kind = next(c for c in CHECK_SEARCHES if c[0] == name)
    B = B0 if B is None else B
    rng = np.random.default_rng(seed)

    def put(x):
        return torch.from_numpy(x).to(device)

    root = RootOutput(prior_logits=put(rng.standard_normal((B, A)).astype(np.float32)),
                      value=put(rng.uniform(-1, 1, B).astype(np.float32)),
                      embedding=put(rng.standard_normal((B, *row)).astype(np.float32)))
    legal = np.ones((B, A), bool)
    legal[:, 1:] = rng.random((B, A - 1)) > 0.2
    noise = rng.dirichlet(np.full(A, 0.3), B).astype(np.float32)
    noise = np.where(legal, noise, 0.0).astype(np.float32)
    fn = check_recurrent_fn(A, kind)
    if kind == "gumbel":
        gumbel = put(rng.gumbel(size=(B, A)).astype(np.float32))
        return (batch_gumbel_search, (root, fn, GumbelSearchConfig(num_simulations=sims),
                                      put(legal)), dict(gumbel=gumbel, device=device))
    cfg = SearchConfig(num_simulations=sims, tie_break="first", stochastic=kind == "chance")
    kwargs = dict(noise=put(noise), device=device,
                  to_play=torch.full((B,), -1, dtype=torch.int32, device=device))
    if kind == "reuse":
        kwargs.update(true_action=put(np.argmax(legal * rng.random((B, A)), axis=1)),
                      reuse_value=put(rng.uniform(-1, 1, B).astype(np.float32)))
    if kind == "chance":
        kwargs.update(
            chance_noise=put(rng.gumbel(size=(sims, sims + 2, B, A)).astype(np.float32)))
    return batch_puct_search, (root, fn, cfg, put(legal)), kwargs
