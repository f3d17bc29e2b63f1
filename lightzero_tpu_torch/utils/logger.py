"""Experiment logging (``lightzero_tpu/utils/logger.py``): scalars as JSON
lines in ``<exp_dir>/log/<name>.jsonl``, messages in ``<exp_dir>/log/<name>.txt``
and on stderr, and the two optional sinks of the JAX logger:

- TensorBoard scalars under ``<exp_dir>/log/serial`` when ``use_tb`` is on
  and the ``tensorboard`` package imports: the event records that torch's
  ``SummaryWriter.add_scalar`` writes, written with tensorboard's own
  record writer. torch's ``SummaryWriter`` (and tensorboard's
  ``EventFileWriter``) import TensorFlow where it is installed, which costs
  seconds in every process.
- wandb, only when ``WANDB_LIGHTZERO=1`` and wandb imports (project
  ``$WANDB_PROJECT``, default "lightzero_tpu").
"""
from __future__ import annotations

import json
import logging
import os
import socket
import time
from typing import Dict


class ScalarEventWriter:
    """TensorBoard scalar events in one events file under ``log_dir``, as
    records of tensorboard's ``RecordWriter`` on a plain file (tensorboard's
    ``EventFileWriter`` opens files through TensorFlow where it is
    installed); raises ``ImportError`` without the ``tensorboard`` package."""

    def __init__(self, log_dir: str):
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary
        from tensorboard.summary.writer.record_writer import RecordWriter

        self._event, self._summary = Event, Summary
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}.{os.getpid()}"
        self._records = RecordWriter(open(os.path.join(log_dir, name), "ab"))
        self._write(Event(wall_time=time.time(), file_version="brain.Event:2"))

    def _write(self, event) -> None:
        self._records.write(event.SerializeToString())

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        summary = self._summary(value=[self._summary.Value(tag=tag, simple_value=value)])
        self._write(self._event(summary=summary, wall_time=time.time(), step=step))

    def flush(self) -> None:
        self._records.flush()

    def close(self) -> None:
        self._records.close()


class ExperimentLogger:
    def __init__(self, exp_dir: str, name: str = "train", use_tb: bool = True):
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
        self.tb = None
        if use_tb:
            try:
                self.tb = ScalarEventWriter(os.path.join(log_dir, "serial"))
            except ImportError:
                self.tb = None
        # the wandb sink (reference use_wandb, train_muzero.py:84-92): only
        # where the run opts in and wandb imports (offline-safe default)
        self.wandb = None
        if os.environ.get("WANDB_LIGHTZERO", "0") == "1":
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self.wandb = wandb
                wandb.init(project=os.environ.get("WANDB_PROJECT", "lightzero_tpu"),
                           name=os.path.basename(exp_dir), dir=log_dir)

    def log_scalars(self, scalars: Dict[str, float], step: int, prefix: str = ""):
        """One JSON line: the step, the time and every value that converts
        to a float (0-d tensors included; others are left out); the same
        values to the TensorBoard and wandb sinks where they are on."""
        clean = {}
        for k, v in scalars.items():
            try:
                clean[prefix + k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        self._jsonl.write(json.dumps({"step": step, "time": time.time(), **clean}) + "\n")
        self._jsonl.flush()
        if self.tb is not None:
            for k, v in clean.items():
                self.tb.add_scalar(k, v, step)
            self.tb.flush()
        if self.wandb is not None:
            self.wandb.log(clean, step=step)

    def info(self, msg: str):
        self.logger.info(msg)

    def close(self):
        self._jsonl.close()
        if self.tb is not None:
            self.tb.close()
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)
