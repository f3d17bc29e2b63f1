"""The reader of ``graph_replay_share.learn``: None where the program
counted no replay of its captured learn step (as on a program that keeps no
such counter), 100 with one entry a step, and the share where some steps
ran eagerly."""
import pytest

from lightzero_tpu_torch.utils import profiling
from port_bench import harness

METRIC = "graph_replay_share.learn"


@pytest.fixture
def counters():
    saved = dict(profiling.counters)
    profiling.counters.clear()
    yield profiling.counters
    profiling.counters.clear()
    profiling.counters.update(saved)


@pytest.mark.parametrize("replays, steps, expected", [
    (None, 10, None), ([], 10, None), ([1.0] * 10, 10, 100.0), ([1.0] * 4, 10, 40.0),
    ([1.0] * 10, 0, None)])
def test_the_share_of_replayed_steps(counters, replays, steps, expected):
    if replays is not None:
        counters["learn_graph.replays"] = replays
    tr = harness.Trace(window_s=1.0, busy_s=0.5, device_ops=10)
    tr.counters.update(steps=steps)
    read = harness.reader(METRIC)(dict(trace=tr, counters=tr.counters))
    assert read == (None if expected is None else pytest.approx(expected))


def test_the_metric_is_declared_for_the_muzero_learn_cell():
    spec = harness.load_spec()
    names = [m["name"] for m in harness.per_layer_for(spec, "atari_muzero.learn.b256")]
    assert METRIC in names
