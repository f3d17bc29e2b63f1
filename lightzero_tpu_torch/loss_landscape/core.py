"""Loss-landscape core (``lightzero_tpu/loss_landscape/core.py``; reference
lzero/loss_landscape/: directions with filter normalisation,
core/direction.py:242-284, and the 1-D and 2-D surfaces,
core/perturbation.py:29): the training loss on a fixed batch at
params + a d1 (+ b d2) over a grid, with per-parameter ("filter")
normalised random directions.

A direction is a dict of tensors keyed as the model's
``named_parameters``. The surfaces evaluate ``loss_fn(model)`` with the
perturbed tensors swapped in by ``torch.func.functional_call`` (and copies
of the buffers, which a forward in training mode may update), so the
model's own parameters and buffers stay bit for bit as they were.
Surfaces are returned as numpy arrays and saved as .npz.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

Direction = Dict[str, torch.Tensor]


def _named_params(model_or_params: Union[nn.Module, Direction]) -> Direction:
    if isinstance(model_or_params, nn.Module):
        return {k: v.detach() for k, v in model_or_params.named_parameters()}
    return dict(model_or_params)


def random_direction(model_or_params: Union[nn.Module, Direction],
                     generator: Optional[torch.Generator] = None,
                     norm: str = "filter") -> Direction:
    """A random direction with the reference's filter normalisation: each
    tensor drawn from a standard normal and rescaled to the norm of its
    parameter, at least 1e-2 (so that the zero-initialised heads of an
    untrained model still move); ``norm='layer'`` rescales each to norm 1.
    Drawn on the parameters' device, in ``named_parameters`` order."""
    out = {}
    for name, leaf in _named_params(model_or_params).items():
        d = torch.randn(leaf.shape, generator=generator, device=leaf.device, dtype=torch.float32)
        if norm == "filter":
            scale = torch.clamp(torch.linalg.vector_norm(leaf.to(torch.float32)), min=1e-2)
            d = d * (scale / torch.clamp(torch.linalg.vector_norm(d), min=1e-10))
        elif norm == "layer":
            d = d / torch.clamp(torch.linalg.vector_norm(d), min=1e-10)
        out[name] = d.to(leaf.dtype)
    return out


class _LossAt(nn.Module):
    """``loss_fn(model)`` as a module's forward, for ``functional_call``."""

    def __init__(self, model: nn.Module, loss_fn: Callable[[nn.Module], torch.Tensor]):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self) -> torch.Tensor:
        return self.loss_fn(self.model)


@torch.no_grad()
def _loss_at(loss_fn, model: nn.Module, params: Direction) -> float:
    swapped = {f"model.{k}": v for k, v in params.items()}
    swapped.update({f"model.{k}": v.clone() for k, v in model.named_buffers()})
    return float(torch.func.functional_call(_LossAt(model, loss_fn), swapped, ()))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A grid coordinate in float32 on the parameters' device, as JAX casts it."""
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def loss_surface_1d(loss_fn: Callable[[nn.Module], torch.Tensor], model: nn.Module,
                    direction: Direction, alphas: Sequence[float]) -> np.ndarray:
    """loss(params + a d) for each a. ``loss_fn(model) -> 0-d tensor``."""
    base = _named_params(model)
    out = []
    for a in alphas:
        p = {k: v + _scalar(a, v) * direction[k] for k, v in base.items()}
        out.append(_loss_at(loss_fn, model, p))
    return np.asarray(out)


def loss_surface_2d(loss_fn: Callable[[nn.Module], torch.Tensor], model: nn.Module,
                    d1: Direction, d2: Direction, alphas: Sequence[float],
                    betas: Sequence[float]) -> np.ndarray:
    """(len(alphas), len(betas)) grid of loss(params + a d1 + b d2)."""
    base = _named_params(model)
    grid = np.zeros((len(alphas), len(betas)))
    for i, a in enumerate(alphas):
        for j, b in enumerate(betas):
            p = {k: v + _scalar(a, v) * d1[k] + _scalar(b, v) * d2[k] for k, v in base.items()}
            grid[i, j] = _loss_at(loss_fn, model, p)
    return grid


def loss_landscape_api(
    policy,
    model: nn.Module,
    batch,
    out_dir: str,
    mode: str = "2d",
    span: float = 1.0,
    steps: int = 11,
    generator: Optional[torch.Generator] = None,
    render: bool = True,
    directions: Optional[Tuple[Direction, Direction]] = None,
) -> dict:
    """Compute and save the loss surface of ``policy._loss_fn`` around
    ``model``'s parameters on ``batch`` (role of reference
    loss_landscape_api and train_unizero_with_loss_landscape's
    post-training phase): ``loss_surface_1d.npz`` (alphas, loss) or
    ``loss_surface_2d.npz`` (alphas, betas, loss) under ``out_dir``, with
    the PNG (and for 2-D the VTK) beside it when ``render``. The two
    directions are drawn from ``generator`` (seed 0 on the parameters'
    device without one) unless ``directions`` gives them."""
    def loss_fn(m):
        loss, _ = policy._loss_fn(m, batch)
        return loss

    os.makedirs(out_dir, exist_ok=True)
    alphas = np.linspace(-span, span, steps)
    if directions is None:
        if generator is None:
            device = next(model.parameters()).device
            generator = torch.Generator(device).manual_seed(0)
        directions = (random_direction(model, generator), random_direction(model, generator))
    d1, d2 = directions
    if mode == "1d":
        surface = loss_surface_1d(loss_fn, model, d1, alphas)
        np.savez(os.path.join(out_dir, "loss_surface_1d.npz"), alphas=alphas, loss=surface)
        out = dict(alphas=alphas, loss=surface)
    else:
        surface = loss_surface_2d(loss_fn, model, d1, d2, alphas, alphas)
        np.savez(os.path.join(out_dir, "loss_surface_2d.npz"), alphas=alphas, betas=alphas,
                 loss=surface)
        out = dict(alphas=alphas, betas=alphas, loss=surface)
    if render:  # PNG + ParaView VTK (reference landscape_plots + h5->vtp)
        from lightzero_tpu_torch.loss_landscape.plots import render_landscape_dir

        try:
            out["rendered"] = render_landscape_dir(out_dir)
        except Exception:  # rendering on the host never kills a run; the surface is saved
            logging.exception("loss_landscape_api: rendering %s failed", out_dir)
            out["rendered"] = []
    return out
