"""``run.py`` from the command line: with no CUDA device it exits non-zero
and prints no result (no fallback to the CPU); a full run of each cell on
the card, a short one, where there is a card."""
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def run(workload: str, seconds: str, trace: str, env=None):
    cmd = [sys.executable, "port_bench/run.py", "--workload", workload, "--seed", "2147483659",
           "--seconds", seconds, "--trace", trace]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)


@pytest.mark.parametrize("workload", CELLS)
def test_run_fails_without_a_card(workload):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run(workload, "1", "0", env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


@pytest.mark.benchmark
@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("workload", CELLS)
def test_run_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    out = run(workload, "3", trace)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
