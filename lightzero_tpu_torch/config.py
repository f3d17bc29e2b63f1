"""Attribute-accessible config tree and experiment compilation (counterpart
of ``lightzero_tpu/config/core.py``: ``Config``, ``deep_merge`` and
``compile_config``).

A copy, not an import: the port loads nothing of the JAX package."""
from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


class Config(dict):
    """Attribute-accessible nested dict (EasyDict-like, self-contained)."""

    def __init__(self, d: Optional[Dict] = None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v: Any) -> Any:
        if isinstance(v, Config):
            return v
        if isinstance(v, dict):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Config._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, Config._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __delattr__(self, k):
        del self[k]

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> Dict:
        return {k: v.to_dict() if isinstance(v, Config) else v for k, v in self.items()}


def deep_merge(base: Dict, override: Dict) -> Config:
    """Return a new Config = base with override recursively applied on top."""
    out = Config(copy.deepcopy(dict(base)))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _json_default(o):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    return repr(o)


def compile_config(cfg: Dict, default_policy_config: Dict, seed: int = 0,
                   save_cfg: bool = True) -> Config:
    """Merge the user's cfg over the policy's default config, stamp the seed
    and the experiment directory, and (with ``save_cfg``) write the merged
    tree to ``<exp_name>/total_config.json`` (with ``ckpt/`` and ``log/``
    beside it), so that an experiment can be rerun from its directory."""
    cfg = Config(copy.deepcopy(dict(cfg)))
    cfg.policy = deep_merge(default_policy_config, cfg.get("policy", {}))
    cfg.seed = seed
    cfg.exp_name = cfg.get("exp_name", f"exp_{time.strftime('%y%m%d_%H%M%S')}")
    if not save_cfg:
        return cfg
    for sub in ("ckpt", "log"):
        os.makedirs(os.path.join(cfg.exp_name, sub), exist_ok=True)
    with open(os.path.join(cfg.exp_name, "total_config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2, default=_json_default)
    return cfg
