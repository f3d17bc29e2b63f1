"""Carry flax parameters of the JAX ``MuZeroModel`` (MLP branch, with the SSL
projector) and ``EfficientZeroModel`` (MLP branch) into the port's models,
and back.

``flax_to_state_dict`` takes the flax params as nested dicts of numpy arrays
(``{"params": {...}}`` or the inner dict), e.g.
``jax.tree_util.tree_map(np.asarray, params)``, and gives a ``state_dict``
for ``MuZeroModel.load_state_dict``. A Dense ``kernel`` (in, out) becomes a
Linear ``weight`` (out, in); a LayerNorm ``scale`` becomes ``weight``.
``state_dict_to_flax`` is its inverse: a port ``state_dict`` as flax-shaped
nested dicts of numpy arrays, to compare updated parameters with the JAX
package's. Both raise on a parameter they do not know, so that nothing is
dropped silently.

EfficientZero's LSTM: flax ``OptimizedLSTMCell`` holds per gate an input
kernel ``i{i,f,g,o}/kernel`` (in, H) without bias and a hidden kernel
``h{i,f,g,o}/kernel`` (H, H) with ``bias``; ``nn.LSTMCell`` holds
``weight_ih`` (4H, in) and ``weight_hh`` (4H, H), rows in gate order i, f,
g, o, and ``bias_hh`` (4H). The kernels are transposed and stacked in that
order, the hidden biases go to ``bias_hh``, and ``bias_ih`` (a zero buffer
in the port's model) is zero; the inverse splits them back and raises if
``bias_ih`` is not zero, which flax could not hold.
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
# flax MLPTorso modules that sit directly on the model (EfficientZero)
_TORSOS.update({"_dyn_torso": "dynamics_torso", "_vp_head": "value_prefix_head"})
_TORSO_LAYERS = {"Dense": "dense", "LayerNorm": "norm"}
_LSTM = "lstm"
_GATES = ("i", "f", "g", "o")
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
    m = re.fullmatch(r"(\w+(?:/MLPTorso_\d+)?)/(Dense|LayerNorm)_(\d+)/(kernel|bias|scale)", key)
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
    m = re.fullmatch(r"_vp_norm/(scale|bias)", key)
    if m is not None:
        return f"value_prefix_norm.{_LEAVES[m.group(1)]}"
    raise KeyError(f"no counterpart in the port for flax parameter {key!r}")


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map flax MuZero MLP params to the port's state_dict keys."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    flat = _flatten(params)
    lstm = {k: flat.pop(k) for k in [k for k in flat if k.startswith("_lstm/")]}
    if lstm:
        out.update(_lstm_to_torch(lstm))
    for key, value in flat.items():
        if key.endswith("/kernel"):
            value = value.T
        out[_port_name(key)] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return out


def _lstm_to_torch(lstm: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """flax ``_lstm/...`` leaves -> ``lstm.*`` tensors (gate order i, f, g, o)."""
    expected = {f"_lstm/i{g}/kernel" for g in _GATES}
    expected |= {f"_lstm/h{g}/{leaf}" for g in _GATES for leaf in ("kernel", "bias")}
    if set(lstm) != expected:
        unknown = sorted(set(lstm) - expected) or sorted(expected - set(lstm))
        raise KeyError(f"no counterpart in the port for flax LSTM parameters {unknown!r}")

    def stack(parts):
        return torch.from_numpy(np.ascontiguousarray(np.concatenate(parts, 0), np.float32))

    bias_hh = stack([lstm[f"_lstm/h{g}/bias"] for g in _GATES])
    return {
        f"{_LSTM}.weight_ih": stack([lstm[f"_lstm/i{g}/kernel"].T for g in _GATES]),
        f"{_LSTM}.weight_hh": stack([lstm[f"_lstm/h{g}/kernel"].T for g in _GATES]),
        f"{_LSTM}.bias_hh": bias_hh,
        f"{_LSTM}.bias_ih": torch.zeros_like(bias_hh),
    }


def _lstm_to_flax(name: str, value: np.ndarray) -> Dict[str, np.ndarray]:
    """One ``lstm.*`` tensor -> its flax leaves ('/'-joined paths)."""
    leaf = name[len(_LSTM) + 1:]
    if leaf == "bias_ih":
        if np.any(value != 0):
            raise ValueError("lstm.bias_ih is not zero: flax's LSTM cell has no input-side bias")
        return {}
    if leaf not in ("weight_ih", "weight_hh", "bias_hh"):
        raise KeyError(f"no counterpart in flax for port parameter {name!r}")
    parts = np.split(value, 4, axis=0)
    side = "i" if leaf == "weight_ih" else "h"
    kind = "bias" if leaf == "bias_hh" else "kernel"
    return {f"_lstm/{side}{g}/{kind}": np.ascontiguousarray(p.T if kind == "kernel" else p)
            for g, p in zip(_GATES, parts)}


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
    paths["value_prefix_norm.weight"] = "_vp_norm/scale"
    paths["value_prefix_norm.bias"] = "_vp_norm/bias"
    return paths


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``flax_to_state_dict``: ``{"params": {...}}`` nested
    dicts of float32 numpy arrays in flax's layout."""
    patterns = _flax_paths()
    flat: Dict[str, np.ndarray] = {}
    for name, tensor in state_dict.items():
        value = tensor.detach().cpu().numpy().astype(np.float32)
        if name.startswith(f"{_LSTM}."):
            flat.update(_lstm_to_flax(name, value))
            continue
        m = re.fullmatch(r"(.+)\.(\d+)\.(weight|bias)", name)
        if m is not None:
            template, idx = f"{m.group(1)}.{{i}}.{m.group(3)}", m.group(2)
        else:
            template, idx = name, ""
        if template not in patterns:
            raise KeyError(f"no counterpart in flax for port parameter {name!r}")
        path = patterns[template].format(i=idx)
        if path.endswith("/kernel"):
            value = np.ascontiguousarray(value.T)
        flat[path] = value
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return {"params": out}
