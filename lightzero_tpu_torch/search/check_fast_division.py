"""Exhaustive check, on the card, of the descent kernel's branch-free division.

    python3 -m lightzero_tpu_torch.search.check_fast_division

``FastDiv`` in ``csrc/fused_traverse.cu`` (a reciprocal from rcp.approx, one
Newton step, the quotient corrected by its residual) is trusted to be the
correctly rounded quotient wherever both operands lie within 2^+-60 of 1.
Within that range every intermediate is normal, so each step scales exactly
with the operands' exponents and signs, and the quotient of any such pair is
the quotient of its significands, scaled. This checks the two facts that
argument rests on, with the kernel's own code:

- for all 2^46 pairs of significands in [1, 2), the quotient is correctly
  rounded (integer arithmetic, independent of '/'), and the fast path takes
  every pair as exact;
- rcp.approx scales exactly: rcp(+-m * 2^j) == +-rcp(m) * 2^-j for every
  significand m and every j in [-61, 61].

It prints the card's name and power limit and one JSON line, and exits 1 if
either fact fails. About a minute on an H100.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from lightzero_tpu_torch import _build

SIGNIFICANDS = 1 << 23
B_PER_LAUNCH = 1 << 16


def main() -> int:
    if not torch.cuda.is_available():
        print("check_fast_division: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    counts = torch.zeros(4, dtype=torch.int64, device="cuda")
    first_bad = torch.zeros(3, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    for begin in range(0, SIGNIFICANDS, B_PER_LAUNCH):
        _build.launch("fused_traverse_check_div_all", counts.device, begin, B_PER_LAUNCH,
                      counts.data_ptr(), first_bad.data_ptr())
        torch.cuda.synchronize()
    wrong, refused, pairs, rcp_bad = (int(x) for x in counts.tolist())
    rec = dict(check="fast_division_exhaustive", pairs=pairs, not_correctly_rounded=wrong,
               not_taken_as_exact=refused, rcp_scaling_mismatches=rcp_bad,
               seconds=time.perf_counter() - t0, card=card)
    if wrong:
        a, b, _ = first_bad.tolist()
        rec["first_wrong_significands"] = [hex(a & 0x7FFFFF), hex(b & 0x7FFFFF)]
    print(json.dumps(rec), flush=True)
    ok = pairs == SIGNIFICANDS * SIGNIFICANDS and not (wrong or refused or rcp_bad)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
