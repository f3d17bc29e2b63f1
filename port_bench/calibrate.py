"""The readings the limits of a cell's comparison are set from.

    python3 port_bench/calibrate.py --workload <name> --seeds 1,2,3 [--faults]

For each seed, in one process and at the cell's own size, without a window:
the numbers the cell compares for the program (sound runs: the lower
readings), for the control (the float32 reference in TF32, in the
program's place: the upper readings) and, with ``--faults``, for the
program with each of its driver's faults planted. One JSON line a seed and
reading; ``run.py``'s runs do not call this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    harness.set_precision()
    spec = harness.load_spec()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = harness.make_cell(spec, args.workload, seed, 0.0, False)
        faults = cell.driver.FAULTS if args.faults else ()
        out = cell.driver.readings(cell, faults)
        for name, numbers in out.items():
            print(json.dumps(dict(workload=args.workload, seed=seed, reading=name, **numbers)),
                  flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
