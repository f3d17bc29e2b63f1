"""Carry flax parameters of the JAX ``MuZeroModel`` (MLP branch, with the SSL
projector) into the port's ``MuZeroModel``, and back.

``flax_to_state_dict`` takes the flax params as nested dicts of numpy arrays
(``{"params": {...}}`` or the inner dict), e.g.
``jax.tree_util.tree_map(np.asarray, params)``, and gives a ``state_dict``
for ``MuZeroModel.load_state_dict``. A Dense ``kernel`` (in, out) becomes a
Linear ``weight`` (out, in); a LayerNorm ``scale`` becomes ``weight``.
``state_dict_to_flax`` is its inverse: a port ``state_dict`` as flax-shaped
nested dicts of numpy arrays, to compare updated parameters with the JAX
package's. Both raise on a parameter they do not know, so that nothing is
dropped silently.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

# flax MLPTorso path -> port MLPTorso path (layers Dense_i / LayerNorm_i)
_TORSOS = {
    "_repr/MLPTorso_0": "representation_network.torso",
    "_dyn/MLPTorso_0": "dynamics_network.torso",
    "_dyn/MLPTorso_1": "dynamics_network.reward_head",
    "_pred/MLPTorso_0": "prediction_network.torso",
    "_pred/MLPTorso_1": "prediction_network.value_head",
    "_pred/MLPTorso_2": "prediction_network.policy_head",
}
_TORSO_LAYERS = {"Dense": "dense", "LayerNorm": "norm"}
# flax SSLProjector layer -> port SSLProjector layer
_PROJECTOR_LAYERS = {"proj": "proj", "proj_norms": "proj_norms", "pred": "pred"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _port_name(key: str) -> str:
    """Port state_dict key of a flax parameter path ('/'-joined)."""
    m = re.fullmatch(r"(\w+/MLPTorso_\d+)/(Dense|LayerNorm)_(\d+)/(kernel|bias|scale)", key)
    if m is not None and m.group(1) in _TORSOS:
        module, layer, idx, leaf = m.groups()
        return f"{_TORSOS[module]}.{_TORSO_LAYERS[layer]}.{idx}.{_LEAVES[leaf]}"
    m = re.fullmatch(r"_proj/(proj|proj_norms|pred)_(\d+)/(kernel|bias|scale)", key)
    if m is not None:
        layer, idx, leaf = m.groups()
        return f"projector.{_PROJECTOR_LAYERS[layer]}.{idx}.{_LEAVES[leaf]}"
    m = re.fullmatch(r"_proj/pred_norm/(scale|bias)", key)
    if m is not None:
        return f"projector.pred_norm.{_LEAVES[m.group(1)]}"
    raise KeyError(f"no counterpart in the port for flax parameter {key!r}")


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map flax MuZero MLP params to the port's state_dict keys."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for key, value in _flatten(params).items():
        if key.endswith("/kernel"):
            value = value.T
        out[_port_name(key)] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return out


def _flax_paths() -> Dict[str, str]:
    """Every port state_dict key this module knows -> its flax path."""
    paths = {}
    for flax_mod, port_mod in _TORSOS.items():
        for flax_layer, port_layer in _TORSO_LAYERS.items():
            leaves = ("kernel", "bias") if flax_layer == "Dense" else ("scale", "bias")
            for leaf in leaves:
                paths[f"{port_mod}.{port_layer}.{{i}}.{_LEAVES[leaf]}"] = (
                    f"{flax_mod}/{flax_layer}_{{i}}/{leaf}"
                )
    for flax_layer, port_layer in _PROJECTOR_LAYERS.items():
        leaves = ("scale", "bias") if flax_layer == "proj_norms" else ("kernel", "bias")
        for leaf in leaves:
            paths[f"projector.{port_layer}.{{i}}.{_LEAVES[leaf]}"] = f"_proj/{flax_layer}_{{i}}/{leaf}"
    paths["projector.pred_norm.weight"] = "_proj/pred_norm/scale"
    paths["projector.pred_norm.bias"] = "_proj/pred_norm/bias"
    return paths


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``flax_to_state_dict``: ``{"params": {...}}`` nested
    dicts of float32 numpy arrays in flax's layout."""
    patterns = _flax_paths()
    out: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        m = re.fullmatch(r"(.+)\.(\d+)\.(weight|bias)", name)
        if m is not None:
            template, idx = f"{m.group(1)}.{{i}}.{m.group(3)}", m.group(2)
        else:
            template, idx = name, ""
        if template not in patterns:
            raise KeyError(f"no counterpart in flax for port parameter {name!r}")
        path = patterns[template].format(i=idx)
        value = tensor.detach().cpu().numpy().astype(np.float32)
        if path.endswith("/kernel"):
            value = np.ascontiguousarray(value.T)
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return {"params": out}
