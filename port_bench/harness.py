"""What every cell of the benchmark shares: the spec in ``BENCHMARK.json``,
the loaders that find a cell's configuration, traffic, driver and metric
readers by name, seeds, weights drawn on the device, the statistics, the
reduction of a profiler trace, the comparison's verdict, and the result's
last line.

Nothing here imports the program under test at module level; drivers do.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
SPEC_PATH = os.path.join(ROOT, "BENCHMARK.json")

# H100 SXM, NVIDIA's data sheet: float32 outside the tensor cores (the
# configurations compute in float32 with TF32 off), and HBM3 bandwidth
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "lightzero_tpu")


def load_spec(path: str = SPEC_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """A Python file of the benchmark by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts: str) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of the spec, resolved: its configuration (the JSON file
    and the module beside it), its traffic parameters and driver, and the
    run's arguments."""

    name: str
    config: dict
    config_module: ModuleType
    traffic: dict
    driver: ModuleType
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = 0.0  # perf_counter at process start


def resolve(spec: dict, workload: str) -> Tuple[dict, dict, dict]:
    """(the workload's entry, its configuration's entry, its traffic file)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    return entry, configs[entry["config"]], load_json("traffic", f"{entry['traffic']}.json")


def make_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
              device: str = "cuda", t_start: float = 0.0) -> Cell:
    entry, conf, traffic = resolve(spec, workload)
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    mod = load_module(os.path.join(BENCH_DIR, "configs", f"{conf['name']}.py"),
                      f"port_bench_config_{conf['name']}")
    driver = load_module(os.path.join(BENCH_DIR, "drivers", f"{traffic['driver']}.py"),
                         f"port_bench_driver_{traffic['driver']}")
    return Cell(workload, config, mod, traffic, driver, seed, seconds, trace, device, t_start)


def per_layer_for(spec: dict, workload: str) -> List[dict]:
    """The per-layer metrics a traced run of ``workload`` reports: those
    whose ``workloads`` list it."""
    return [m for m in spec["per_layer"] if workload in m["workloads"]]


def end_to_end_for(spec: dict, workload: str) -> List[dict]:
    return [m for m in spec["end_to_end"] if "workloads" not in m or workload in m["workloads"]]


def reader(metric_name: str) -> Callable[[dict], Optional[float]]:
    mod = load_module(os.path.join(BENCH_DIR, "metrics", f"{metric_name}.py"),
                      f"port_bench_metric_{metric_name.replace('.', '_')}")
    return mod.read


# ------------------------------------------------------------------ seeds

def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed for one use of the run's seed (a call, a pool)."""
    entropy = [int(seed) % (1 << 64), *(int(k) for k in keys)]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@torch.no_grad()
def draw_weights(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights for every parameter of ``model`` (its names and shapes only;
    it may live on the meta device), drawn on ``device`` from ``seed`` in
    one call: a tensor of rank >= 2 is normal with std 1/sqrt(fan in) (a
    Linear, a conv, an embedding row), a LayerNorm's weight 1 + 0.1 z, any
    other vector 0.1 z, and a 0-d parameter (a learned scalar such as
    UniZero's log alpha) 0. Every head's last layer is drawn too: their
    zero init would make every search a tie."""
    norms = {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, torch.nn.LayerNorm)}
    named = sorted((n, tuple(p.shape)) for n, p in model.named_parameters())
    total = sum(math.prod(s) for _, s in named)
    z = torch.randn(total, generator=generator(device, seed), device=device)
    out, at = {}, 0
    for name, shape in named:
        n = math.prod(shape)
        v = z[at:at + n].reshape(shape)
        at += n
        if len(shape) >= 2:
            out[name] = v * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif len(shape) == 1:
            out[name] = 1.0 + 0.1 * v if name in norms else 0.1 * v
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def set_precision() -> None:
    """float32 with TF32 off in cuBLAS and cuDNN: the configurations' stated
    arithmetic, set before anything is built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class hardware_tf32:
    """TF32 switched on in cuBLAS and cuDNN for a block: the controls' own
    arithmetic on the card, beside the references' rounding of operands."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


# ------------------------------------------------------------- statistics

def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def stages(t_start: float, marks: List[Tuple[str, float]]) -> Dict[str, float]:
    """Seconds of each stage of set-up from its marks (name, end time)."""
    out, prev = {}, t_start
    for name, t in marks:
        out[name] = t - prev
        prev = t
    return out


# ---------------------------------------------------------------- device

def device_info(chips: int, memory_peak_bytes: int) -> dict:
    """The result's ``device``; the peak is read by the cell's driver when the
    window closes, before the reference runs."""
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
                memory_peak_bytes=memory_peak_bytes)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        info["power_limit"] = out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit"] = None
    return info


def forbidden_loaded() -> List[str]:
    """The modules in ``sys.modules`` whose top-level name is forbidden,
    compared whole (``lightzero_tpu_torch`` is not ``lightzero_tpu``)."""
    return sorted(k for k in list(sys.modules) if k.split(".")[0] in FORBIDDEN_MODULES)


# ------------------------------------------------------------------ trace

def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def profiler_activities(device: str) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@dataclass
class Trace:
    """A profiled window reduced to what the readers need."""

    window_s: float
    busy_s: float = 0.0
    device_ops: int = 0
    kernel_s: Dict[str, float] = field(default_factory=dict)  # device seconds by op name
    kernel_n: Dict[str, int] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, Any] = field(default_factory=dict)  # the cell's driver's counts


def _raw_events(prof) -> List[Tuple[str, bool, int, int, bool, int]]:
    """(name, on_device, start_ns, end_ns, is_user_annotation, thread) of
    every event of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        out.append((e.name(), dev, e.start_ns(), e.start_ns() + e.duration_ns(),
                    bool(e.is_user_annotation()), e.start_thread_id()))
    return out


def _top_level(ops: List[Tuple[int, int, str, int]]) -> List[Tuple[int, int, str]]:
    """The host ops that no other op of their thread encloses."""
    out, reach = [], {}
    for s, e, name, thread in sorted(ops):
        if s >= reach.get(thread, -math.inf):
            out.append((s, e, name))
            reach[thread] = e
    return sorted(out)


def _open_at(items: List[Tuple[int, int, str]], starts: List[int], t: int, default: str) -> str:
    """The name of the latest-starting item that is still open at t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        if items[j][1] >= t:
            return items[j][2]
    return default


def reduce_trace(prof, window_s: float, spans: Tuple[str, ...]) -> Trace:
    """Device busy time as the union of the intervals of all device activity
    (kernels, copies, fills), leaving out the user annotations that
    ``record_function`` mirrors onto the device timeline (copied from
    ``chip_smoke.py`` ``device_busy``); device time and count by op name;
    and the idle gaps of the device, each charged to what the host was
    doing at the gap's middle: the benchmark's own span (one of ``spans``)
    and the outermost host op open then."""
    tr = Trace(window_s=window_s)
    dev, host_spans, host_ops = [], [], []
    for name, on_dev, s, e, annot, thread in _raw_events(prof):
        if on_dev:
            if annot:
                continue
            dev.append((s, e))
            tr.kernel_s[name] = tr.kernel_s.get(name, 0.0) + (e - s) * 1e-9
            tr.kernel_n[name] = tr.kernel_n.get(name, 0) + 1
        elif name in spans:
            host_spans.append((s, e, name))
        else:
            host_ops.append((s, e, name, thread))
    tr.device_ops = len(dev)
    busy, reach, gaps = 0, -math.inf, []
    for s, e in sorted(dev):
        if e > reach:
            if reach != -math.inf and s > reach:
                gaps.append((reach, s))
            busy += e - max(s, reach)
            reach = e
    tr.busy_s = busy * 1e-9
    host_spans.sort()
    tops = _top_level(host_ops)
    span_starts, top_starts = [s for s, _, _ in host_spans], [s for s, _, _ in tops]
    for a, b in gaps:
        t = (a + b) // 2
        key = (f"{_open_at(host_spans, span_starts, t, 'outside_spans')}/"
               f"{_open_at(tops, top_starts, t, 'no_host_op')}")
        tr.idle_by_host[key] = tr.idle_by_host.get(key, 0.0) + (b - a) * 1e-9
    return tr


def breakdown(tr: Trace) -> dict:
    ops = sorted(tr.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(tr.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[n[:120], s] for n, s in ops], idle_gaps=[[n[:120], s] for n, s in idle])


# ------------------------------------------------------------- comparison

@dataclass
class Check:
    """One number compared with its limit: ``ok`` when value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)  # NaN fails


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys=None) -> Tuple[float, str]:
    """max over leaves |prog norm - ref norm| / max(ref norm, the median
    leaf's ref norm), and the leaf that gives it; a leaf the program has no
    reading of counts as a norm of 0."""
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref[k] for k in keys)
    worst, at = 0.0, ""
    for k in keys:
        gap = abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
        if not gap <= worst:  # NaN wins
            worst, at = gap, k
    return worst, at


class Patches:
    """Attributes of the program swapped for the duration of a block (the
    drivers' planted faults), put back on exit."""

    def __init__(self):
        self.undo = []

    def swap(self, obj, name: str, new) -> None:
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    def __exit__(self, *exc):
        for obj, name, old in reversed(self.undo):
            setattr(obj, name, old)
        self.undo = []
        return False


# ---------------------------------------------------------------- result

def emit(result: dict, checks: List[Check]) -> None:
    """The checks as the last lines of standard error, then the result as the
    last line of standard output, the checks under the last key."""
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = {c.name: dict(value=c.value, limit=c.limit) for c in checks}
    print(json.dumps(result), flush=True)
