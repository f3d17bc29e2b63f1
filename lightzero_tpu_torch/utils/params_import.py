"""Carry flax parameters of the JAX ``MuZeroModel`` (MLP branch) into the
port's ``MuZeroModel``.

Input: the flax params as nested dicts of numpy arrays (``{"params": {...}}``
or the inner dict), e.g. ``jax.tree_util.tree_map(np.asarray, params)``.
Output: a ``state_dict`` for ``MuZeroModel.load_state_dict``. A Dense
``kernel`` (in, out) becomes a Linear ``weight`` (out, in); a LayerNorm
``scale`` becomes ``weight``. The SSL projector (``_proj``, training only) is
not part of the serving model and is skipped.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

# flax submodule path -> port submodule path
_MODULES = {
    "_repr/MLPTorso_0": "representation_network.torso",
    "_dyn/MLPTorso_0": "dynamics_network.torso",
    "_dyn/MLPTorso_1": "dynamics_network.reward_head",
    "_pred/MLPTorso_0": "prediction_network.torso",
    "_pred/MLPTorso_1": "prediction_network.value_head",
    "_pred/MLPTorso_2": "prediction_network.policy_head",
}
_SKIPPED = ("_proj",)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map flax MuZero MLP params to the port's state_dict keys. Raises on a
    parameter it does not know, so that nothing is dropped silently."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for key, value in _flatten(params).items():
        if key.split("/")[0] in _SKIPPED:
            continue
        m = re.fullmatch(r"(\w+/MLPTorso_\d+)/(Dense|LayerNorm)_(\d+)/(kernel|bias|scale)", key)
        if m is None or m.group(1) not in _MODULES:
            raise KeyError(f"no counterpart in the port for flax parameter {key!r}")
        module, layer, idx, leaf = m.groups()
        if layer == "Dense":
            name = f"{_MODULES[module]}.dense.{idx}.{'weight' if leaf == 'kernel' else 'bias'}"
            if leaf == "kernel":
                value = value.T
        else:
            name = f"{_MODULES[module]}.norm.{idx}.{'weight' if leaf == 'scale' else 'bias'}"
        out[name] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
    return out
