"""Run one cell of the benchmark once.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads`` entry) names its configuration
(``configs/<config>.json`` and the module beside it) and its traffic
(``traffic/<mix>.json``, whose ``driver`` names the program in
``drivers/``). The cell's driver builds the program from the seed, warms up the
cell's shapes, runs the measured window (``--seconds`` of closed-loop calls;
with ``--trace 1`` the traffic file's traced calls under ``torch.profiler``),
and compares what the timed path produced with the plain reference
(``reference/<family>.py``) once the window has closed. With ``--trace 0``
the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``metrics/<name>.py``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit);
the last lines of standard error list the same checks. The run exits
non-zero, printing no result, without a CUDA device (or with fewer than the
cell asks for), or when JAX, flax or the JAX package is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.load_spec()
    entry, _, _ = harness.resolve(spec, args.workload)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    harness.set_precision()
    cell = harness.make_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START)
    out = cell.driver.run(cell)
    result = finish(spec, cell, out, chips)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"run.py: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for k, v in out["info"].items():
        print(f"info {k} {v}", file=sys.stderr)
    harness.emit(result, out["checks"])
    return 0


def finish(spec: dict, cell: harness.Cell, out: dict, chips: int) -> dict:
    """The result line's fields from a driver's outcome."""
    device = harness.device_info(chips, out["memory_peak_bytes"])
    if cell.trace:
        tr = out["trace"]
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        metrics = {}
        for m in harness.per_layer_for(spec, cell.name):
            value = harness.reader(m["name"])(dict(trace=tr, counters=tr.counters))
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        extra = dict(breakdown=harness.breakdown(tr))
    else:
        units = {m["name"]: m["unit"] for m in harness.end_to_end_for(spec, cell.name)}
        metrics = {k: dict(value=v, unit=units[k]) for k, v in out["metrics"].items()
                   if k in units}
        extra = {}
    correct = all(c.ok for c in out["checks"])
    return dict(correct=correct, attempted=out["attempted"], failed=out["failed"],
                metrics=metrics, device=device, **extra)


if __name__ == "__main__":
    sys.exit(main())
