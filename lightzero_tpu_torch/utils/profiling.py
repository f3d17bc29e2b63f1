"""Profiling and runtime metrics (``lightzero_tpu/utils/profiling.py``): a
wall-clock phase timer that feeds the ``ExperimentLogger``, a
``torch.profiler`` trace context for deep dives, and the replay buffer's
occupancy counters.

``torch_trace`` takes the place of the JAX module's ``jax_trace``: it
records the host's ops and, where the work runs on the card, the device's
kernels, and writes a Chrome trace (open it in ``chrome://tracing`` or
Perfetto) under ``log_dir``.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class PhaseTimer:
    """Accumulates wall-clock per named phase; drain with ``snapshot()``."""

    def __init__(self):
        self._tot: Dict[str, float] = defaultdict(float)
        self._cnt: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._tot[name] += time.perf_counter() - t0
            self._cnt[name] += 1

    def snapshot(self, reset: bool = True) -> Dict[str, float]:
        out = {}
        for k in list(self._tot):
            out[f"{k}_time_avg"] = self._tot[k] / max(self._cnt[k], 1)
            out[f"{k}_time_total"] = self._tot[k]
        if reset:
            self._tot.clear()
            self._cnt.clear()
        return out


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block and write it as
    ``<log_dir>/trace.json``: the host's ops, and the card's kernels where
    CUDA is available. Yields the profiler, whose ``key_averages()`` sum the
    time by op::

        with torch_trace(f"{exp}/log/profile"):
            policy.forward_learn(state, batch)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def buffer_metrics(buffer) -> Dict[str, float]:
    """Occupancy and throughput counters of a ``GameBuffer`` (reference
    log_buffer_memory_usage / log_buffer_run_time, entry/utils.py:914-1005):
    transitions and episodes held, transitions ever pushed, and the bytes of
    the episodes' observations, actions and visit distributions."""
    return dict(
        transitions=float(buffer.num_transitions),
        episodes=float(buffer.num_episodes),
        pushed_transitions=float(buffer._pushed_transitions),
        approx_bytes=float(sum(e.obs.nbytes + e.actions.nbytes + e.child_visits.nbytes
                               for e in buffer._episodes)),
    )
