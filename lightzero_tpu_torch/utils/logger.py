"""Experiment logging (``lightzero_tpu/utils/logger.py``): scalars as JSON
lines in ``<exp_dir>/log/<name>.jsonl``, messages in ``<exp_dir>/log/<name>.txt``
and on stderr. The JAX logger's TensorBoard and wandb sinks are not ported."""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict


class ExperimentLogger:
    def __init__(self, exp_dir: str, name: str = "train"):
        self.exp_dir = exp_dir
        log_dir = os.path.join(exp_dir, "log")
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, f"{name}.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self.logger = logging.getLogger(f"lightzero_tpu_torch.{name}.{id(self)}")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        fh = logging.FileHandler(os.path.join(log_dir, f"{name}.txt"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S"))
        self.logger.addHandler(fh)
        self.logger.addHandler(sh)

    def log_scalars(self, scalars: Dict[str, float], step: int, prefix: str = ""):
        """One JSON line: the step, the time and every value that converts
        to a float (0-d tensors included; others are left out)."""
        clean = {}
        for k, v in scalars.items():
            try:
                clean[prefix + k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        self._jsonl.write(json.dumps({"step": step, "time": time.time(), **clean}) + "\n")
        self._jsonl.flush()

    def info(self, msg: str):
        self.logger.info(msg)

    def close(self):
        self._jsonl.close()
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)
