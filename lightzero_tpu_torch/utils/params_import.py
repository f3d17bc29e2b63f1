"""Carry flax parameters of the JAX ``MuZeroModel`` (with the SSL projector),
``EfficientZeroModel``, ``StochasticMuZeroModel``, ``SampledMuZeroModel``,
``SampledEfficientZeroModel`` (MLP and conv branches), ``MuZeroRNNModel``
(MLP), ``AlphaZeroModel`` and ``UniZeroModel`` into the port's models, and
back.

``flax_to_state_dict`` takes the flax params as nested dicts of numpy arrays
(``{"params": {...}}`` or the inner dict), e.g.
``jax.tree_util.tree_map(np.asarray, params)``, and gives a ``state_dict``
for the port model's ``load_state_dict``. A Dense ``kernel`` (in, out)
becomes a Linear ``weight`` (out, in); a LayerNorm ``scale`` becomes
``weight``. ``state_dict_to_flax`` is its inverse: a port ``state_dict`` as
flax-shaped nested dicts of numpy arrays, to compare updated parameters with
the JAX package's. Both raise on a parameter they do not know, so that
nothing is dropped silently.

Each model class has its own map (``_PARAM_MAPS``), since the same name
means different modules in different models: MuZero's flax ``_dyn`` holds
two torsos and the port's ``dynamics_network`` a torso and a reward head,
while Stochastic MuZero's ``_dyn`` and ``dynamics_network`` are one torso.
The map is picked by a module that only its model has: ``_gru`` (port:
``gru``) for MuZero-RNN; else ``_common`` (port: ``prediction_torso``) for
the two sampled models, with ``_lstm`` (port: ``lstm``) for Sampled
EfficientZero; else ``_lstm`` for EfficientZero, ``_afterstate_dyn`` (port:
``afterstate_dynamics_network``) for Stochastic MuZero, else MuZero's.

The LSTM of both EfficientZero models: flax ``OptimizedLSTMCell`` holds per
gate an input kernel ``i{i,f,g,o}/kernel`` (in, H) without bias and a hidden kernel
``h{i,f,g,o}/kernel`` (H, H) with ``bias``; ``nn.LSTMCell`` holds
``weight_ih`` (4H, in) and ``weight_hh`` (4H, H), rows in gate order i, f,
g, o, and ``bias_hh`` (4H). The kernels are transposed and stacked in that
order, the hidden biases go to ``bias_hh``, and ``bias_ih`` (a zero buffer
in the port's model) is zero; the inverse splits them back and raises if
``bias_ih`` is not zero, which flax could not hold.

The conv branches (a model with a 4-D kernel) take one map for all five
models (``_conv_port_name``): the port's conv modules keep flax's submodule
order in lists, so a flax path maps segment by segment. The top module by
``_CONV_TOPS`` (``_dyn_blocks_i`` -> ``dynamics_blocks.i``), then ``Conv_i``
-> ``conv.i``, ``LayerNorm_i`` -> ``norm.i``, ``ResBlock_i`` -> ``res.i``,
``DownSample_0`` -> ``downsample``, ``MLPTorso_i`` -> ``mlp.i``, ``Dense_i``
-> ``dense.i``, and the projector's ``proj_i``, ``proj_norms_i``, ``pred_i``
-> ``proj.i``, ``proj_norms.i``, ``pred.i``. AlphaZero's modules sit at the
top (``Conv_0``, ``LayerNorm_0``, ``ResBlock_i``, ``MLPTorso_i``), so its
top segments map as lists too (``Conv_0`` -> ``conv.0``). A conv ``kernel`` (kh, kw, in,
out) becomes a ``weight`` (out, in, kh, kw); the way back tells a
LayerNorm ``weight`` (1-D, flax ``scale``) from a Dense (2-D) or conv (4-D)
``kernel`` by its rank.

UniZero (a flax tree with ``_wm``; a port state_dict with ``transformer.``)
maps segment by segment (``_unizero_port_name``): the tops by ``_UZ_TOPS``
(``_wm`` -> ``transformer``, ``_dec_convs_i`` -> ``decoder_convs.i``), a
numbered submodule ``X_i`` as a list entry (``Block_i`` and ``ViTBlock_i`` ->
``blocks.i``, ``Dense_i`` -> ``dense.i``, ``LayerNorm_i`` -> ``norm.i``,
``Conv_i`` -> ``conv.i``, ``ResBlock_i`` -> ``res.i``, ``expert_e`` ->
``experts.e``), ``SelfAttention_0`` and ``MultiHeadDotProductAttention_0``
-> ``attn``, ``MoELayer_0`` -> ``moe``, ``DownSample_0`` -> ``downsample``,
and the names ``qkv``, ``out_proj``, ``ff_up``, ``ff_down``, ``gate``,
``base``, ``task_embed``, ``query``, ``key``, ``value``, ``out`` as they
are. A Dense or conv ``kernel``, a LayerNorm ``scale`` and an Embed
``embedding`` become ``weight`` (transposed as above; an embedding table is
(num, D) on both sides); the attention's 3-D kernels, the LoRA factors and
scales, ``pos_embed`` and ``log_alpha`` keep flax's layout and name. An
MoE with a shared expert (the port's ``moe.shared``, which the JAX
``MoELayer`` does not have) is refused with a ValueError, either way.

MuZero's multitask task embedding (flax ``task_embed/embedding``, MLP and
conv) is the port's ``task_embed.weight``, (num_tasks, width) on both sides.
MuZero's HarmonyDream scalars (flax top-level ``harmony_policy``,
``harmony_value``, ``harmony_reward``, MLP and conv) keep their names, 0-d on
both sides.

The RND reward model's two nets (``reward_model/rnd.py``): flax holds the
target and the predictor as two param trees of ``_RNDNet``, each
``MLPTorso_0``; the port's ``RNDRewardModel`` holds them as ``target.torso``
and ``predictor.torso``. ``rnd_flax_to_state_dict`` and
``rnd_state_dict_to_flax`` carry them across.

The GRU of MuZero-RNN: flax ``GRUCell`` holds input kernels ``i{r,z,n}``
(in, H) with ``bias``, recurrent kernels ``h{r,z}`` (H, H) without and
``hn`` with ``bias``; the port's ``FlaxGRUCell`` holds ``weight_ih`` (3H,
in) and ``bias_ih`` (3H), rows in gate order r, z, n, ``weight_hh`` (3H, H)
and ``bias_hn`` (H). The kernels are transposed and stacked in that order.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, NamedTuple

import numpy as np
import torch

_TORSO_LAYERS = {"Dense": "dense", "LayerNorm": "norm"}
_LSTM = "lstm"
_GATES = ("i", "f", "g", "o")
_GRU = "gru"
_GRU_GATES = ("r", "z", "n")
# flax SSLProjector layer -> port SSLProjector layer
_PROJECTOR_LAYERS = {"proj": "proj", "proj_norms": "proj_norms", "pred": "pred"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
# MuZero's task embedding (num_tasks > 0): flax path -> port name
_TASK_EMBED = ("task_embed/embedding", "task_embed.weight")
# MuZero's HarmonyDream scalars (harmony_balance): the same name on both sides
_HARMONY = ("harmony_policy", "harmony_value", "harmony_reward")


class _ParamMap(NamedTuple):
    """One model class's names: flax MLPTorso path -> port MLPTorso path
    (layers Dense_i / LayerNorm_i), flax bare LayerNorm -> port LayerNorm,
    and whether the model has the SSL projector (``_proj``), the LSTM and
    the GRU."""

    torsos: Dict[str, str]
    norms: Dict[str, str]
    projector: bool
    lstm: bool
    gru: bool = False


# the MLP representation and prediction networks every model has
_REPR_PRED = {
    "_repr/MLPTorso_0": "representation_network.torso",
    "_pred/MLPTorso_0": "prediction_network.torso",
    "_pred/MLPTorso_1": "prediction_network.value_head",
    "_pred/MLPTorso_2": "prediction_network.policy_head",
}
# the prediction side of both sampled models: a common torso, the value head,
# and the Gaussian (mu, sigma) heads or the logits head
_SAMPLED_PRED = {
    "_repr/MLPTorso_0": "representation_network.torso",
    "_common": "prediction_torso",
    "_value_head": "value_head",
    "_mu_head": "mu_head",
    "_sigma_head": "sigma_head",
    "_policy_head": "policy_head",
}
_PARAM_MAPS = {
    "MuZeroModel": _ParamMap(
        torsos=dict(_REPR_PRED, **{"_dyn/MLPTorso_0": "dynamics_network.torso",
                                   "_dyn/MLPTorso_1": "dynamics_network.reward_head"}),
        norms={}, projector=True, lstm=False),
    "EfficientZeroModel": _ParamMap(
        torsos=dict(_REPR_PRED, _dyn_torso="dynamics_torso", _vp_head="value_prefix_head"),
        norms={"_vp_norm": "value_prefix_norm"}, projector=True, lstm=True),
    "StochasticMuZeroModel": _ParamMap(
        torsos=dict(
            _REPR_PRED,
            **{"_afterstate_pred/MLPTorso_0": "afterstate_prediction_network.torso",
               "_afterstate_pred/MLPTorso_1": "afterstate_prediction_network.value_head",
               "_afterstate_pred/MLPTorso_2": "afterstate_prediction_network.policy_head"},
            _afterstate_dyn="afterstate_dynamics_network",
            _dyn="dynamics_network",
            _reward_head="reward_head",
            _chance_encoder="chance_encoder",
        ),
        norms={}, projector=False, lstm=False),
    "SampledMuZeroModel": _ParamMap(
        torsos=dict(_SAMPLED_PRED, _dyn_torso="dynamics_torso", _reward_head="reward_head"),
        norms={}, projector=True, lstm=False),
    "SampledEfficientZeroModel": _ParamMap(
        torsos=dict(_SAMPLED_PRED, _dyn_torso="dynamics_torso", _vp_head="value_prefix_head"),
        norms={"_vp_norm": "value_prefix_norm"}, projector=True, lstm=True),
    "MuZeroRNNModel": _ParamMap(
        torsos={"_repr/MLPTorso_0": "representation_network.torso",
                "_dyn_torso": "dynamics_torso", "_reward_head": "reward_head",
                "_common": "prediction_torso", "_value_head": "value_head",
                "_policy_head": "policy_head"},
        norms={}, projector=True, lstm=False, gru=True),
}


# flax top-level module -> port attribute, for every conv model
_CONV_TOPS = {
    "_repr": "representation_network", "_dyn": "dynamics_network",
    "_pred": "prediction_network", "_afterstate_pred": "afterstate_prediction_network",
    "_proj": "projector",
    "_dyn_conv": "dynamics_conv", "_dyn_norm": "dynamics_norm", "_dyn_blocks": "dynamics_blocks",
    "_as_dyn_conv": "afterstate_dynamics_conv", "_as_dyn_norm": "afterstate_dynamics_norm",
    "_as_dyn_blocks": "afterstate_dynamics_blocks",
    "_vp_reduce": "value_prefix_reduce", "_vp_reduce_norm": "value_prefix_reduce_norm",
    "_vp_norm": "value_prefix_norm", "_vp_head": "value_prefix_head",
    "_reward_reduce": "reward_reduce", "_reward_reduce_norm": "reward_reduce_norm",
    "_reward_head": "reward_head",
    "_chance_conv": "chance_conv", "_chance_norm": "chance_norm", "_chance_head": "chance_head",
}
_CONV_TOPS_BACK = {v: k for k, v in _CONV_TOPS.items()}
# flax submodule -> port list attribute (``Conv_3`` -> ``conv.3``); the
# projector's own lists are ``proj_i`` etc. on both sides
_CONV_LISTS = {"Conv": "conv", "LayerNorm": "norm", "ResBlock": "res", "MLPTorso": "mlp",
               "Dense": "dense", "proj": "proj", "proj_norms": "proj_norms", "pred": "pred"}
_CONV_LISTS_BACK = {v: k for k, v in _CONV_LISTS.items()}


def _is_conv_flax(flat: Mapping[str, Any]) -> bool:
    return any(np.ndim(v) == 4 for v in flat.values())


def _conv_port_name(key: str) -> str:
    """Port state_dict key of a conv model's flax parameter path."""
    top, *mods, leaf = key.split("/")
    m = re.fullmatch(r"(\w+?)_(\d+)", top)
    if top in _CONV_TOPS:
        parts = [_CONV_TOPS[top]]
    elif m is not None and m.group(1) in _CONV_TOPS and m.group(1).endswith("_blocks"):
        parts = [_CONV_TOPS[m.group(1)], m.group(2)]
    elif m is not None and m.group(1) in _CONV_LISTS:
        parts = [_CONV_LISTS[m.group(1)], m.group(2)]  # AlphaZero
    else:
        raise KeyError(f"no counterpart in the port for flax parameter {key!r}")
    for mod in mods:
        m = re.fullmatch(r"(\w+?)_(\d+)", mod)
        if mod == "DownSample_0":
            parts.append("downsample")
        elif mod == "pred_norm":
            parts.append(mod)
        elif m is not None and m.group(1) in _CONV_LISTS:
            parts += [_CONV_LISTS[m.group(1)], m.group(2)]
        else:
            raise KeyError(f"no counterpart in the port for flax parameter {key!r}")
    if leaf not in _LEAVES:
        raise KeyError(f"no counterpart in the port for flax parameter {key!r}")
    return ".".join(parts + [_LEAVES[leaf]])


def _conv_flax_path(name: str, ndim: int) -> str:
    """The inverse of ``_conv_port_name`` ('/'-joined flax path)."""
    *mods, leaf = name.split(".")
    if not mods or leaf not in ("weight", "bias"):
        raise KeyError(f"no counterpart in flax for port parameter {name!r}")
    top = _CONV_TOPS_BACK.get(mods[0])
    rest = mods[1:]
    if top is None and mods[0] in _CONV_LISTS_BACK and rest and rest[0].isdigit():
        top, rest = f"{_CONV_LISTS_BACK[mods[0]]}_{rest[0]}", rest[1:]  # AlphaZero
    elif top is None:
        raise KeyError(f"no counterpart in flax for port parameter {name!r}")
    if top.endswith("_blocks"):
        if not rest or not rest[0].isdigit():
            raise KeyError(f"no counterpart in flax for port parameter {name!r}")
        top, rest = f"{top}_{rest[0]}", rest[1:]
    parts, i = [top], 0
    while i < len(rest):
        mod = rest[i]
        if mod == "downsample":
            parts.append("DownSample_0")
            i += 1
        elif mod == "pred_norm":
            parts.append(mod)
            i += 1
        elif mod in _CONV_LISTS_BACK and i + 1 < len(rest) and rest[i + 1].isdigit():
            parts.append(f"{_CONV_LISTS_BACK[mod]}_{rest[i + 1]}")
            i += 2
        else:
            raise KeyError(f"no counterpart in flax for port parameter {name!r}")
    parts.append("bias" if leaf == "bias" else ("scale" if ndim == 1 else "kernel"))
    return "/".join(parts)


def _map_of_flax(flat: Mapping[str, Any]) -> _ParamMap:
    tops = {k.split("/")[0] for k in flat}
    if "_gru" in tops:
        return _PARAM_MAPS["MuZeroRNNModel"]
    if "_common" in tops:
        return _PARAM_MAPS["SampledEfficientZeroModel" if "_lstm" in tops else "SampledMuZeroModel"]
    if "_lstm" in tops:
        return _PARAM_MAPS["EfficientZeroModel"]
    if "_afterstate_dyn" in tops:
        return _PARAM_MAPS["StochasticMuZeroModel"]
    return _PARAM_MAPS["MuZeroModel"]


def _map_of_port(names) -> _ParamMap:
    tops = {k.split(".")[0] for k in names}
    if _GRU in tops:
        return _PARAM_MAPS["MuZeroRNNModel"]
    if "prediction_torso" in tops:
        return _PARAM_MAPS["SampledEfficientZeroModel" if _LSTM in tops else "SampledMuZeroModel"]
    if _LSTM in tops:
        return _PARAM_MAPS["EfficientZeroModel"]
    if "afterstate_dynamics_network" in tops:
        return _PARAM_MAPS["StochasticMuZeroModel"]
    return _PARAM_MAPS["MuZeroModel"]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _port_name(pmap: _ParamMap, key: str) -> str:
    """Port state_dict key of a flax parameter path ('/'-joined)."""
    m = re.fullmatch(r"(.+)/(Dense|LayerNorm)_(\d+)/(kernel|bias|scale)", key)
    if m is not None and m.group(1) in pmap.torsos:
        module, layer, idx, leaf = m.groups()
        return f"{pmap.torsos[module]}.{_TORSO_LAYERS[layer]}.{idx}.{_LEAVES[leaf]}"
    if pmap.projector:
        m = re.fullmatch(r"_proj/(proj|proj_norms|pred)_(\d+)/(kernel|bias|scale)", key)
        if m is not None:
            layer, idx, leaf = m.groups()
            return f"projector.{_PROJECTOR_LAYERS[layer]}.{idx}.{_LEAVES[leaf]}"
        m = re.fullmatch(r"_proj/pred_norm/(scale|bias)", key)
        if m is not None:
            return f"projector.pred_norm.{_LEAVES[m.group(1)]}"
    m = re.fullmatch(r"(\w+)/(scale|bias)", key)
    if m is not None and m.group(1) in pmap.norms:
        return f"{pmap.norms[m.group(1)]}.{_LEAVES[m.group(2)]}"
    raise KeyError(f"no counterpart in the port for flax parameter {key!r}")


# UniZero's flax tops -> the port's attributes
_UZ_TOPS = {
    "_enc": "encoder", "_enc_conv": "encoder_conv", "_enc_proj": "encoder_proj",
    "_enc_vit": "encoder_vit", "_simnorm": "latent_norm", "_act_embed": "action_embed",
    "_act_embed_dense": "action_embed_dense", "_mu_head": "mu_head", "_sigma_head": "sigma_head",
    "_wm": "transformer", "_value_head": "value_head", "_policy_head": "policy_head",
    "_reward_head": "reward_head", "_obs_head": "obs_head", "_dec": "decoder",
    "_dec_proj": "decoder_proj", "_dec_out": "decoder_out",
}
_UZ_TOPS_BACK = {v: k for k, v in _UZ_TOPS.items()}
_UZ_LISTS = {"Block": "blocks", "ViTBlock": "blocks", "Dense": "dense", "LayerNorm": "norm",
             "Conv": "conv", "ResBlock": "res", "expert": "experts", "_dec_convs": "decoder_convs"}
_UZ_SINGLE = {"SelfAttention_0": "attn", "MultiHeadDotProductAttention_0": "attn",
              "MoELayer_0": "moe", "DownSample_0": "downsample"}
_UZ_NAMES = ("qkv", "out_proj", "ff_up", "ff_down", "gate", "base", "task_embed", "query",
             "key", "value", "out")
_UZ_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}
_UZ_RAW_LEAF = re.compile(r"pos_embed|base_scale|log_alpha|(lora_A|lora_B|adapter_scale)_\d+")


def _unizero_port_name(key: str) -> str:
    """Port state_dict key of a UniZero flax parameter path."""
    *mods, leaf = key.split("/")
    parts = []
    for i, mod in enumerate(mods):
        m = re.fullmatch(r"(\w+?)_(\d+)", mod)
        if i == 0 and mod in _UZ_TOPS:
            parts.append(_UZ_TOPS[mod])
        elif mod in _UZ_SINGLE:
            parts.append(_UZ_SINGLE[mod])
        elif mod in _UZ_NAMES:
            parts.append(mod)
        elif m is not None and m.group(1) in _UZ_LISTS:
            parts += [_UZ_LISTS[m.group(1)], m.group(2)]
        else:
            raise KeyError(f"no counterpart in the port for flax parameter {key!r}")
    if _UZ_RAW_LEAF.fullmatch(leaf):
        return ".".join(parts + [leaf])
    if leaf not in _UZ_LEAVES or not parts:
        raise KeyError(f"no counterpart in the port for flax parameter {key!r}")
    return ".".join(parts + [_UZ_LEAVES[leaf]])


def _unizero_flax_path(name: str, ndim: int) -> str:
    """The inverse of ``_unizero_port_name`` ('/'-joined flax path)."""
    *mods, leaf = name.split(".")
    vit = bool(mods) and mods[0] == "encoder_vit"
    lists_back = {"blocks": "ViTBlock" if vit else "Block", "dense": "Dense",
                  "norm": "LayerNorm", "conv": "Conv", "res": "ResBlock", "experts": "expert",
                  "decoder_convs": "_dec_convs"}
    single_back = {"attn": "MultiHeadDotProductAttention_0" if vit else "SelfAttention_0",
                   "moe": "MoELayer_0", "downsample": "DownSample_0"}
    parts, i = [], 0
    while i < len(mods):
        mod = mods[i]
        if i == 0 and mod in _UZ_TOPS_BACK:
            parts.append(_UZ_TOPS_BACK[mod])
        elif mod in single_back:
            parts.append(single_back[mod])
        elif mod in _UZ_NAMES:
            parts.append(mod)
        elif mod in lists_back and i + 1 < len(mods) and mods[i + 1].isdigit():
            parts.append(f"{lists_back[mod]}_{mods[i + 1]}")
            i += 1
        else:
            raise KeyError(f"no counterpart in flax for port parameter {name!r}")
        i += 1
    if _UZ_RAW_LEAF.fullmatch(leaf):
        return "/".join(parts + [leaf])
    if leaf == "bias" and parts:
        return "/".join(parts + ["bias"])
    if leaf != "weight" or not parts:
        raise KeyError(f"no counterpart in flax for port parameter {name!r}")
    if mods[-1] in ("action_embed", "task_embed"):
        return "/".join(parts + ["embedding"])
    return "/".join(parts + ["scale" if ndim == 1 else "kernel"])


def _refuse_shared_experts(keys, sep: str) -> None:
    """A ValueError for an MoE with a shared expert: the JAX ``MoELayer``
    has none, so such a model maps neither way."""
    shared = [k for k in keys if any(a in ("moe", "MoELayer_0") and b.startswith("shared")
                                     for a, b in zip(k.split(sep), k.split(sep)[1:]))]
    if shared:
        raise ValueError(f"{shared[0]!r} is a shared expert of the MoE, which the JAX package's "
                         "MoELayer does not have: the model cannot be mapped to or from flax")


def _unizero_to_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    _refuse_shared_experts(flat, "/")
    out = {}
    for key, value in flat.items():
        if key.endswith("/kernel"):
            # Dense (in, out) -> (out, in); conv HWIO -> OIHW; attention 3-D as is
            value = {2: lambda x: x.T, 4: lambda x: x.transpose(3, 2, 0, 1)}.get(
                value.ndim, lambda x: x)(value)
        out[_unizero_port_name(key)] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return out


def _unizero_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    _refuse_shared_experts(state_dict, ".")
    flat = {}
    for name, tensor in state_dict.items():
        value = tensor.detach().cpu().numpy().astype(np.float32)
        path = _unizero_flax_path(name, value.ndim)
        if path.endswith("/kernel"):
            value = {2: lambda x: x.T, 4: lambda x: x.transpose(2, 3, 1, 0)}.get(
                value.ndim, lambda x: x)(value)
        flat[path] = np.array(value, order="C")  # 0-d stays 0-d (log_alpha, scales)
    return flat


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map flax params of one of the seven models to the port's state_dict
    keys."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    flat = _flatten(params)
    if "_wm" in {k.split("/")[0] for k in flat}:
        return _unizero_to_state_dict(flat)
    conv = _is_conv_flax(flat)
    pmap = _map_of_flax(flat)
    if pmap.lstm:
        out.update(_lstm_to_torch({k: flat.pop(k) for k in list(flat) if k.startswith("_lstm/")}))
    if pmap.gru:
        out.update(_gru_to_torch({k: flat.pop(k) for k in list(flat) if k.startswith("_gru/")}))
    if _TASK_EMBED[0] in flat:
        out[_TASK_EMBED[1]] = torch.from_numpy(np.array(flat.pop(_TASK_EMBED[0]), np.float32))
    for name in _HARMONY:
        if name in flat:
            out[name] = torch.from_numpy(np.array(flat.pop(name), np.float32))
    for key, value in flat.items():
        if key.endswith("/kernel"):
            # Dense (in, out) -> (out, in); conv HWIO -> OIHW
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        name = _conv_port_name(key) if conv else _port_name(pmap, key)
        out[name] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
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


def _gru_to_torch(gru: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """flax ``_gru/...`` leaves -> ``gru.*`` tensors (gate order r, z, n)."""
    expected = {f"_gru/i{g}/{leaf}" for g in _GRU_GATES for leaf in ("kernel", "bias")}
    expected |= {f"_gru/h{g}/kernel" for g in _GRU_GATES} | {"_gru/hn/bias"}
    if set(gru) != expected:
        unknown = sorted(set(gru) - expected) or sorted(expected - set(gru))
        raise KeyError(f"no counterpart in the port for flax GRU parameters {unknown!r}")

    def stack(parts):
        return torch.from_numpy(np.ascontiguousarray(np.concatenate(parts, 0), np.float32))

    return {
        f"{_GRU}.weight_ih": stack([gru[f"_gru/i{g}/kernel"].T for g in _GRU_GATES]),
        f"{_GRU}.bias_ih": stack([gru[f"_gru/i{g}/bias"] for g in _GRU_GATES]),
        f"{_GRU}.weight_hh": stack([gru[f"_gru/h{g}/kernel"].T for g in _GRU_GATES]),
        f"{_GRU}.bias_hn": stack([gru["_gru/hn/bias"]]),
    }


def _gru_to_flax(name: str, value: np.ndarray) -> Dict[str, np.ndarray]:
    """One ``gru.*`` tensor -> its flax leaves ('/'-joined paths)."""
    leaf = name[len(_GRU) + 1:]
    if leaf == "bias_hn":
        return {"_gru/hn/bias": np.ascontiguousarray(value)}
    if leaf not in ("weight_ih", "bias_ih", "weight_hh"):
        raise KeyError(f"no counterpart in flax for port parameter {name!r}")
    side = "h" if leaf == "weight_hh" else "i"
    kind = "bias" if leaf == "bias_ih" else "kernel"
    return {f"_gru/{side}{g}/{kind}": np.ascontiguousarray(p.T if kind == "kernel" else p)
            for g, p in zip(_GRU_GATES, np.split(value, 3, axis=0))}


def _flax_paths(pmap: _ParamMap) -> Dict[str, str]:
    """Every port state_dict key of the model -> its flax path."""
    paths = {}
    for flax_mod, port_mod in pmap.torsos.items():
        for flax_layer, port_layer in _TORSO_LAYERS.items():
            leaves = ("kernel", "bias") if flax_layer == "Dense" else ("scale", "bias")
            for leaf in leaves:
                paths[f"{port_mod}.{port_layer}.{{i}}.{_LEAVES[leaf]}"] = (
                    f"{flax_mod}/{flax_layer}_{{i}}/{leaf}"
                )
    if pmap.projector:
        for flax_layer, port_layer in _PROJECTOR_LAYERS.items():
            leaves = ("scale", "bias") if flax_layer == "proj_norms" else ("kernel", "bias")
            for leaf in leaves:
                paths[f"projector.{port_layer}.{{i}}.{_LEAVES[leaf]}"] = (
                    f"_proj/{flax_layer}_{{i}}/{leaf}"
                )
        paths["projector.pred_norm.weight"] = "_proj/pred_norm/scale"
        paths["projector.pred_norm.bias"] = "_proj/pred_norm/bias"
    for flax_mod, port_mod in pmap.norms.items():
        paths[f"{port_mod}.weight"] = f"{flax_mod}/scale"
        paths[f"{port_mod}.bias"] = f"{flax_mod}/bias"
    return paths


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``flax_to_state_dict``: ``{"params": {...}}`` nested
    dicts of float32 numpy arrays in flax's layout."""
    pmap = _map_of_port(state_dict)
    patterns = _flax_paths(pmap)
    conv = any(t.dim() == 4 for t in state_dict.values())
    flat: Dict[str, np.ndarray] = {}
    unizero = any(k.startswith("transformer.") for k in state_dict)
    for name, tensor in state_dict.items() if not unizero else ():
        value = tensor.detach().cpu().numpy().astype(np.float32)
        if pmap.lstm and name.startswith(f"{_LSTM}."):
            flat.update(_lstm_to_flax(name, value))
            continue
        if pmap.gru and name.startswith(f"{_GRU}."):
            flat.update(_gru_to_flax(name, value))
            continue
        if name == _TASK_EMBED[1]:
            flat[_TASK_EMBED[0]] = value
            continue
        if name in _HARMONY:
            flat[name] = value
            continue
        if conv:
            path = _conv_flax_path(name, value.ndim)
            if path.endswith("/kernel"):
                value = np.ascontiguousarray(
                    value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T)
            flat[path] = value
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
    if unizero:
        flat = _unizero_to_flax(state_dict)
    return _nest(flat)


def _nest(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """'/'-joined flax paths -> ``{"params": nested dicts}``."""
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return {"params": out}


# the RND net: flax's one MLPTorso -> the port's ``torso``
_RND_MAP = _ParamMap(torsos={"MLPTorso_0": "torso"}, norms={}, projector=False, lstm=False)
_RND_NETS = ("target", "predictor")


def rnd_flax_to_state_dict(target_params: Mapping[str, Any],
                           predictor_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX RND model's target and predictor param trees (``RNDState``'s
    ``target_params`` and ``predictor_params``) as a state_dict of the
    port's ``RNDRewardModel``."""
    out: Dict[str, torch.Tensor] = {}
    for net, params in zip(_RND_NETS, (target_params, predictor_params)):
        for key, value in _flatten(params.get("params", params)).items():
            if key.endswith("/kernel"):
                value = value.T
            out[f"{net}.{_port_name(_RND_MAP, key)}"] = torch.from_numpy(
                np.array(value, dtype=np.float32, order="C"))
    return out


def rnd_state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> tuple:
    """The inverse of ``rnd_flax_to_state_dict``: (target params, predictor
    params), each ``{"params": {...}}`` in flax's layout."""
    patterns = _flax_paths(_RND_MAP)
    flats = {net: {} for net in _RND_NETS}
    for name, tensor in state_dict.items():
        net, _, rest = name.partition(".")
        m = re.fullmatch(r"(.+)\.(\d+)\.(weight|bias)", rest)
        template = f"{m.group(1)}.{{i}}.{m.group(3)}" if m is not None else None
        if net not in flats or template not in patterns:
            raise KeyError(f"no counterpart in flax for port parameter {name!r}")
        path = patterns[template].format(i=m.group(2))
        value = tensor.detach().cpu().numpy().astype(np.float32)
        flats[net][path] = np.ascontiguousarray(value.T) if path.endswith("/kernel") else value
    return tuple(_nest(flats[net]) for net in _RND_NETS)
