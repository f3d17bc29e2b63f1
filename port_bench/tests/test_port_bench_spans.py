"""The readers of the program's spans (``port_bench/spans.py`` and the six
metrics on it) and what the spans do to the harness's idle attribution.

- Each reader on a synthetic ``Trace`` and record gives its share, and
  None with no span of its layer recorded (as on a program without spans).
- A tiny search profiled on the CPU inside the driver's ``search_call``:
  the program's spans are the outermost host ops (``harness._top_level``)
  for at least 90 % of the host time inside ``search_call``.
- On the card (a short run where there is one): every span holds the
  start of its own ``record_function`` event in a profile with CUDA
  activity, and the spans' device-side mirrors stay out of the device ops.
"""
import pytest
import torch

from conftest import SEARCH, small_cell
from lightzero_tpu_torch.utils import profiling
from port_bench import harness

S = profiling.Span
WINDOW_S = 2.0
RECORD = [S("model.initial", None, 1, 7, 0, 100_000_000), S("puct.select", None, 1, 7, 100_000_000,
                                                            400_000_000),
          S("model.recurrent", None, 1, 7, 400_000_000, 900_000_000),
          S("puct.backup", None, 1, 7, 900_000_000, 1_000_000_000),
          S("learn.readback", None, 2, 7, 1_000_000_000, 1_300_000_000),
          S("learn.optimizer", None, 2, 7, 1_300_000_000, 1_500_000_000)]
IDLE = {"search_call/model.initial": 0.02, "search_call/model.recurrent": 0.18,
        "search_call/puct.select": 0.1, "search_call/puct.backup": 0.06,
        "search_call/aten::where": 0.5, "learn_step/learn.optimizer": 0.04,
        "learn_step/learn.readback": 0.01, "outside_spans/no_host_op": 0.3}
EXPECTED = {"model_idle_share.search": 10.0, "loop_idle_share.search": 8.0,
            "model_host_share.search": 30.0, "loop_host_share.search": 20.0,
            "readback_wait_share.learn": 15.0, "optimizer_idle_share.learn": 2.0}


@pytest.fixture
def record():
    saved = list(profiling.record)
    profiling.record.clear()
    yield profiling.record
    profiling.record[:] = saved


def trace():
    return harness.Trace(window_s=WINDOW_S, busy_s=0.5, device_ops=10, idle_by_host=dict(IDLE))


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_synthetic_trace_and_record(metric, record):
    read = harness.reader(metric)
    tr = trace()
    assert read(dict(trace=tr, counters=tr.counters)) is None
    record.extend(RECORD)
    assert read(dict(trace=tr, counters=tr.counters)) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", ["model_idle_share.search", "optimizer_idle_share.learn"])
def test_idle_readers_need_a_device_trace(metric, record):
    record.extend(RECORD)
    tr = harness.Trace(window_s=WINDOW_S, idle_by_host=dict(IDLE))
    assert harness.reader(metric)(dict(trace=tr, counters=tr.counters)) is None


def traced_search(device: str, activities):
    """Two search calls of the small cell on ``device`` under the profiler
    (the first warms up); the profiler and the calls' spans."""
    cell = small_cell(SEARCH)
    cell.device = device
    driver, cfg = cell.driver, cell.config
    policy, _ = cell.config_module.build(cfg, cell.seed, device)
    inputs = driver.Inputs(cfg, cell.traffic, cell.seed, device)
    driver.search_call(policy, inputs, cell.traffic, 0)
    profiling.record.clear()
    with torch.profiler.profile(activities=activities) as prof:
        driver.search_call(policy, inputs, cell.traffic, 1)
    return prof, list(profiling.record)


NAMES = ("model.initial", "puct.roots", "puct.select", "model.recurrent", "puct.backup",
         "puct.result", "policy.act")


def test_program_spans_cover_the_host_time_inside_search_call(record):
    prof, _ = traced_search("cpu", harness.profiler_activities("cpu"))
    events = [e for e in harness._raw_events(prof) if not e[1]]
    (call,) = [(s, e) for name, _, s, e, _, _ in events if name == "search_call"]
    inside = [(s, e, name, thread) for name, _, s, e, _, thread in events
              if call[0] <= s and e <= call[1] and name != "search_call"]
    tops = harness._top_level(inside)
    covered = sum(e - s for s, e, name in tops if name in NAMES)
    assert {name for _, _, name in tops} >= set(NAMES)
    assert covered >= 0.9 * (call[1] - call[0]), (covered, call[1] - call[0], tops)


@pytest.mark.benchmark
def test_spans_share_the_profilers_clock_on_the_card(record):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    prof, spans = traced_search("cuda", harness.profiler_activities("cuda"))
    starts, mirrored = {}, set()
    for name, on_dev, s, _, annot, _ in harness._raw_events(prof):
        if name in NAMES and not on_dev:
            starts.setdefault(name, []).append(s)
        if on_dev and annot:
            mirrored.add(name)
    assert {s.name for s in spans} == set(NAMES)
    for name in NAMES:
        own = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        assert len(own) == len(starts[name]), name
        for s, t in zip(own, sorted(starts[name])):
            assert s.start_ns <= t <= s.end_ns, (name, s, t)
    tr = harness.reduce_trace(prof, 1.0, ("search_call", "batch_next"))
    assert tr.device_ops > 0 and not set(tr.kernel_s) & set(NAMES)
    assert mirrored & set(NAMES), mirrored
