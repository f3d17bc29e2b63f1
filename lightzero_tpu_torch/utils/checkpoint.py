"""Checkpoint save and restore (``lightzero_tpu/utils/checkpoint.py``).

A checkpoint is one file, ``<path>.pt``, written with ``torch.save``: the
state dicts of the online model, the target model, the optimizer and its
learning-rate schedule, and ``train_iter``. A params export holds the two
models only. Loading restores into a ``TrainState`` in place. A state
without a target model or a schedule (AlphaZero's ``AZTrainState``) saves
and restores the fields it has.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import torch

# errors a state dict that does not fit its target raises on loading
_MISFIT = (KeyError, ValueError, RuntimeError)


def _file(path: str) -> str:
    path = os.path.abspath(path)
    return path if path.endswith(".pt") else path + ".pt"


def _save(obj: Dict[str, Any], path: str) -> str:
    out = _file(path)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = out + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, out)  # a crash while saving leaves the previous file whole
    return out


_MODELS = ("model", "target_model")
_FIELDS = _MODELS + ("optimizer", "lr_scheduler")


def _state_dicts(state, fields) -> Dict[str, Any]:
    return {f: getattr(state, f).state_dict() for f in fields if hasattr(state, f)}


def save_checkpoint(state, path: str) -> str:
    """Save a ``TrainState``; returns the file written."""
    return _save(dict(_state_dicts(state, _FIELDS), train_iter=int(state.train_iter)), path)


def save_params_export(state, path: str) -> str:
    """The models only: several times smaller than a checkpoint, and
    what evaluation and warm starts need. ``load_checkpoint_lenient``
    restores it into any ``TrainState``, keeping the fresh optimizer."""
    return _save(_state_dicts(state, _MODELS), path)


def _load_optimizer(optimizer: torch.optim.Optimizer, saved: Dict[str, Any]) -> None:
    """``optimizer.load_state_dict`` after checking each saved moment's
    shape against its parameter's (torch would load a misfit silently)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for i, st in saved["state"].items():
        if int(i) >= len(params):
            raise ValueError(f"the saved optimizer has state for parameter {i} of {len(params)}")
        for name, value in st.items():
            if torch.is_tensor(value) and value.ndim > 0 and value.shape != params[int(i)].shape:
                raise ValueError(
                    f"saved {name} of parameter {i} has shape {tuple(value.shape)}, "
                    f"the parameter {tuple(params[int(i)].shape)}"
                )
    optimizer.load_state_dict(saved)


def load_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """The saved dict, or, with ``target``, the ``TrainState`` restored in
    place from it (every field must fit)."""
    raw = torch.load(_file(path), map_location="cpu", weights_only=True)
    if target is None:
        return raw
    for field, load in _loaders(target).items():
        load(raw[field])
    return target._replace(train_iter=int(raw["train_iter"]))


def _loaders(target: Any) -> Dict[str, Any]:
    """The fields of ``target`` -> the function that restores each."""
    loaders = {f: getattr(target, f).load_state_dict for f in _FIELDS if hasattr(target, f)}
    loaders["optimizer"] = lambda sd: _load_optimizer(target.optimizer, sd)
    return loaders


def load_checkpoint_lenient(path: str, target: Any) -> Any:
    """Restore what fits: a full checkpoint as ``load_checkpoint`` does; a
    params export, or a checkpoint whose optimizer no longer fits, field by
    field, keeping the fresh optimizer (as a new learner loading a
    ``model_path``). The online model must fit."""
    try:
        return load_checkpoint(path, target=target)
    except _MISFIT as e:
        raw = load_checkpoint(path)
        ok, failed = [], []
        for field, load in _loaders(target).items():
            try:
                load(raw[field])
                ok.append(field)
            except _MISFIT:
                failed.append(field)
        if "model" not in ok:
            raise e
        restored = target
        if "train_iter" in raw:
            restored = target._replace(train_iter=int(raw["train_iter"]))
            ok.append("train_iter")
        logging.warning("load_checkpoint_lenient(%s): restored %s; kept fresh %s", path, ok, failed)
        return restored
