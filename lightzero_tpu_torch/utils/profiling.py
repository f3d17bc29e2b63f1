"""Profiling and runtime metrics (``lightzero_tpu/utils/profiling.py``): the
program's spans, a ``torch.profiler`` trace context that writes them beside
its Chrome trace, and the replay buffer's occupancy counters.

Spans. ``span(name)`` marks one layer's part of a call (the search's
``puct.*`` and ``model.*`` steps, the learn step's ``learn.*`` phases). It
is on exactly while a ``torch.profiler`` profile is active: then it enters
``torch.profiler.record_function(name)``, so the span is in the profiler's
trace and on its device-side mirror, and appends a ``Span`` to ``record``,
stamped with the profiler's own clock (``time.time_ns()``, the clock of its
host events). Outside a profile it is one check and a shared no-op context:
no allocation, no device op, no host sync. ``new_request()``, called on
entry by the policies' ``_forward_collect`` and ``forward_learn``, gives
the spans of one call a shared id. ``summary()`` sums the record by name.

Counters. ``count(name, value)`` keeps a device tensor under ``name`` in
``counters`` while a profile is active (the MoE layers' per-expert token
counts, ``moe.tokens_per_expert``), as it is: no read-back, which is left
to whoever reads ``counters`` after the profile. Outside a profile it is
one check.

``torch_trace`` takes the place of the JAX module's ``jax_trace``: it
records the host's ops and, where the work runs on the card, the device's
kernels, and writes a Chrome trace (open it in ``chrome://tracing`` or
Perfetto) and the program's spans under ``log_dir``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    parent: Optional[str]  # the enclosing span on the same thread
    request: int  # the call's id (``new_request``); 0 before the thread's first
    thread: int  # the thread's native id
    start_ns: int  # time.time_ns(), the profiler's clock
    end_ns: int


class _Thread(threading.local):
    """Each thread's open spans, request id and native id (read once: on
    some hosts the call is a system call costing tens of us)."""

    def __init__(self):
        self.stack: List[str] = []
        self.request = 0
        self.id = threading.get_native_id()


# the spans recorded while a profile was active, in the order they closed
record: List[Span] = []
# the counters' device tensors recorded while a profile was active, by name,
# in the order they were recorded
counters: Dict[str, List[torch.Tensor]] = {}
_local = _Thread()
_requests = itertools.count(1)
_OFF = contextlib.nullcontext()
_on = torch.autograd._profiler_enabled  # True while a profile is active


def new_request() -> None:
    """Give the calling thread's next spans a new request id (a no-op
    outside a profile)."""
    if _on():
        _local.request = next(_requests)


class _Span:
    """A span's bookkeeping runs inside its ``record_function`` event, so
    that the host time between two spans' events, which the profiler
    charges to no layer, is as short as it can be. Its start is read before
    the event opens: the span holds its event's start."""

    __slots__ = ("name", "parent", "start_ns", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start_ns = time.time_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack = _local.stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        return self

    def __exit__(self, *exc):
        local = _local
        local.stack.pop()
        record.append(Span(self.name, self.parent, local.request, local.id, self.start_ns,
                           time.time_ns()))
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that records ``name`` while a profile is active, else the
    shared no-op."""
    return _Span(name) if _on() else _OFF


def count(name: str, value: torch.Tensor) -> None:
    """Keep ``value`` under ``name`` in ``counters`` while a profile is
    active (a no-op outside one)."""
    if _on():
        counters.setdefault(name, []).append(value.detach())


def summary(spans: Optional[List[Span]] = None) -> Dict[str, Dict[str, float]]:
    """Each span name's ``count``, ``total_s`` and ``self_s`` (the duration
    less what its child spans on the same thread cover) over ``spans``,
    ``record`` by default."""
    spans = record if spans is None else spans
    out: Dict[str, Dict[str, float]] = {}
    selfs: Dict[int, float] = {}
    by_thread: Dict[int, List[int]] = {}
    for i, s in enumerate(spans):
        by_thread.setdefault(s.thread, []).append(i)
        selfs[i] = (s.end_ns - s.start_ns) * 1e-9
    for ids in by_thread.values():
        open_: List[int] = []
        for i in sorted(ids, key=lambda i: (spans[i].start_ns, -spans[i].end_ns)):
            while open_ and spans[open_[-1]].end_ns <= spans[i].start_ns:
                open_.pop()
            if open_:
                selfs[open_[-1]] -= (spans[i].end_ns - spans[i].start_ns) * 1e-9
            open_.append(i)
    for i, s in enumerate(spans):
        row = out.setdefault(s.name, dict(count=0, total_s=0.0, self_s=0.0))
        row["count"] += 1
        row["total_s"] += (s.end_ns - s.start_ns) * 1e-9
        row["self_s"] += selfs[i]
    return out


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block and write it as
    ``<log_dir>/trace.json``: the host's ops, the program's spans, and the
    card's kernels where CUDA is available; and the spans as
    ``<log_dir>/spans.json`` (``summary``, the raw ``spans`` and the
    ``counters`` as lists). The record and the counters are cleared on
    entry. Yields the profiler, whose
    ``key_averages()`` sum the time by op::

        with torch_trace(f"{exp}/log/profile"):
            policy.forward_learn(state, batch)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    record.clear()
    counters.clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(dict(summary=summary(), spans=[s._asdict() for s in record],
                       counters={k: [v.tolist() for v in vs] for k, vs in counters.items()}), f)


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
