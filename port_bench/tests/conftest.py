"""Small cells for the benchmark's CPU tests: the cells of BENCHMARK.json
with their widths, batches and simulations cut so that a test run holds
them; every other key as the cell has it."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402

SEARCH = "atari_muzero.collect_search.b2048"
LEARN = "atari_unizero.learn.b64"


def small_cell(workload: str, seed: int = 2147483947, seconds: float = 1.0,
               trace: bool = False) -> harness.Cell:
    cell = harness.make_cell(harness.load_spec(), workload, seed, seconds, trace, "cpu")
    model = cell.config["policy"]["model"]
    if workload == SEARCH:
        model.update(observation_shape=[32, 32, 4], num_channels=16, support_scale=10)
        cell.config["policy"]["num_simulations"] = 8
        cell.traffic.update(roots=16, obs_pool=2, noise_pool=4, warmup_calls=1, trace_calls=3)
    else:
        model.update(observation_shape=[32, 32, 3], num_channels=16, support_scale=10,
                     embed_dim=64, num_heads=4)
        cell.config["policy"]["num_unroll_steps"] = 4
        cell.traffic.update(batch=4, trace_steps=3)
    return cell


@pytest.fixture
def search_cell():
    return small_cell(SEARCH)


@pytest.fixture
def learn_cell():
    return small_cell(LEARN)
