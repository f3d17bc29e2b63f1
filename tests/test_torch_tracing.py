"""The port's spans (lightzero_tpu_torch/utils/profiling.py) on the CPU.

- With no profiler active, ``span()`` is the shared no-op and records
  nothing; ``new_request()`` does nothing.
- Under ``torch.profiler``, a tiny MuZero collect search records the flat
  spans with one ``model.recurrent``, ``puct.select`` and ``puct.backup``
  a simulation and one request id a call; a tiny UniZero learn step
  records its four learn spans, once a micro-batch for the forward and
  the backward, each under the span that encloses the call.
- Each recorded span's [start_ns, end_ns] holds the start of its own
  ``record_function`` event in the profiler's events: one clock.
- ``summary()`` takes a child span's time out of its parent's self time;
  ``torch_trace`` clears the record and writes ``spans.json``.
"""
import json

import pytest
import torch

from lightzero_tpu_torch.policy import MuZeroPolicy, UniZeroPolicy
from lightzero_tpu_torch.policy.muzero import TrainBatch
from lightzero_tpu_torch.utils import profiling

pytestmark = pytest.mark.unittest

SIMS = 4
B, A = 3, 2
SEARCH_SPANS = ("model.initial", "puct.roots", "puct.select", "model.recurrent", "puct.backup",
                "puct.result", "policy.act")
LEARN_SPANS = ("learn.forward", "learn.backward", "learn.readback", "learn.optimizer")
MUZERO = dict(
    model=dict(observation_shape=4, action_space_size=A, model_type="mlp", latent_state_dim=16,
               support_scale=5),
    num_simulations=SIMS,
)
UNROLL = 2
UNIZERO = dict(
    model=dict(observation_shape=4, action_space_size=A, embed_dim=16, num_layers=1, num_heads=2,
               max_tokens=8, support_scale=5),
    num_simulations=SIMS, num_unroll_steps=UNROLL, batch_size=4,
)


@pytest.fixture(autouse=True)
def empty_record():
    profiling.record.clear()
    yield
    profiling.record.clear()


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def collect(policy, seed):
    g = torch.Generator().manual_seed(seed)
    obs = torch.rand((B, 4), generator=g)
    legal = torch.ones((B, A), dtype=torch.bool)
    return policy._forward_collect(obs, legal, torch.full((B,), -1), 1.0, 0.25)


def learn_batch(seed, batch=4):
    g = torch.Generator().manual_seed(seed)
    return TrainBatch(
        obs=torch.randn((batch, UNROLL + 1, 4), generator=g),
        actions=torch.randint(0, A, (batch, UNROLL), generator=g),
        mask=torch.ones((batch, UNROLL)),
        target_reward=torch.randn((batch, UNROLL), generator=g),
        target_value=torch.randn((batch, UNROLL + 1), generator=g),
        target_policy=torch.softmax(torch.randn((batch, UNROLL + 1, A), generator=g), -1),
        weights=torch.ones(batch),
    )


def counts(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def test_span_off_records_nothing_and_is_the_shared_noop():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("puct.select") is profiling.span("model.recurrent")
    before = getattr(profiling._local, "request", None)
    profiling.new_request()
    assert getattr(profiling._local, "request", None) == before
    collect(MuZeroPolicy(MUZERO, device="cpu"), 0)
    assert profiling.record == []


def test_collect_search_records_flat_spans_one_request_a_call():
    policy = MuZeroPolicy(MUZERO, device="cpu")
    calls = 2
    with profiled():
        for i in range(calls):
            collect(policy, i)
    spans = list(profiling.record)
    got = counts(spans)
    assert set(got) == set(SEARCH_SPANS)
    for name in ("puct.select", "model.recurrent", "puct.backup"):
        assert got[name] == calls * SIMS, name
    for name in ("model.initial", "puct.roots", "puct.result", "policy.act"):
        assert got[name] == calls, name
    assert all(s.parent is None for s in spans)
    requests = [s.request for s in spans]
    assert len(set(requests)) == calls and requests == sorted(requests)
    per_call = len(spans) // calls
    assert all(len({s.request for s in spans[i * per_call:(i + 1) * per_call]}) == 1
               for i in range(calls))
    # one call's spans in order: the model's root, the roots, then each
    # simulation's select, recurrent inference and backup
    first = [s.name for s in spans[:per_call]]
    assert first == (["model.initial", "puct.roots"]
                     + ["puct.select", "model.recurrent", "puct.backup"] * SIMS
                     + ["puct.result", "policy.act"])


@pytest.mark.parametrize("accumulation_steps", [1, 2])
def test_unizero_learn_step_records_the_four_learn_spans(accumulation_steps):
    policy = UniZeroPolicy(dict(UNIZERO, accumulation_steps=accumulation_steps), device="cpu")
    state = policy.init_train_state()
    with profiled():
        with profiling.span("caller"):
            state, logs, _ = policy.forward_learn(state, learn_batch(0))
        policy.forward_learn(state, learn_batch(1))
    assert float(logs["nonfinite_loss"]) == 0.0
    spans = [s for s in profiling.record if s.name != "caller"]
    assert counts(spans) == {"learn.forward": 2 * accumulation_steps,
                             "learn.backward": 2 * accumulation_steps,
                             "learn.readback": 2, "learn.optimizer": 2}
    half = len(spans) // 2
    assert all(s.parent == "caller" for s in spans[:half])
    assert all(s.parent is None for s in spans[half:])
    assert len({s.request for s in spans[:half]}) == 1
    assert len({s.request for s in spans[half:]}) == 1
    assert spans[0].request != spans[-1].request
    assert [s.name for s in spans[:half]] == (["learn.forward", "learn.backward"]
                                              * accumulation_steps
                                              + ["learn.readback", "learn.optimizer"])


def test_spans_and_the_profilers_events_share_one_clock():
    policy = UniZeroPolicy(UNIZERO, device="cpu")
    state = policy.init_train_state()
    with profiled() as prof:
        collect(MuZeroPolicy(MUZERO, device="cpu"), 0)
        policy.forward_learn(state, learn_batch(0))
    names = set(SEARCH_SPANS) | set(LEARN_SPANS)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events.setdefault(e.name(), []).append(e.start_ns())
    spans = {}
    for s in profiling.record:
        spans.setdefault(s.name, []).append(s)
    assert set(spans) == names
    for name, recorded in spans.items():
        starts = sorted(events[name])
        assert len(starts) == len(recorded), name
        for s, t in zip(sorted(recorded, key=lambda s: s.start_ns), starts):
            assert s.start_ns <= t <= s.end_ns, (name, s, t)


def test_summary_takes_child_time_out_of_self_time():
    S = profiling.Span
    spans = [S("outer", None, 1, 7, 0, 100), S("inner", "outer", 1, 7, 10, 30),
             S("inner", "outer", 1, 7, 40, 50), S("outer", None, 2, 8, 20, 60)]
    got = profiling.summary(spans)
    assert got["outer"]["count"] == 2 and got["inner"]["count"] == 2
    assert got["outer"]["total_s"] == pytest.approx(140e-9)
    assert got["outer"]["self_s"] == pytest.approx(110e-9)  # 70 + 40 (other thread)
    assert got["inner"]["self_s"] == pytest.approx(30e-9)


def test_torch_trace_writes_spans_json(tmp_path):
    profiling.record.append(profiling.Span("stale", None, 0, 0, 0, 1))
    policy = MuZeroPolicy(MUZERO, device="cpu")
    with profiling.torch_trace(str(tmp_path / "profile")):
        collect(policy, 0)
    with open(tmp_path / "profile" / "spans.json") as f:
        written = json.load(f)
    assert set(written["summary"]) == set(SEARCH_SPANS)
    assert written["summary"]["model.recurrent"]["count"] == SIMS
    assert len(written["spans"]) == sum(r["count"] for r in written["summary"].values())
    assert set(written["spans"][0]) == set(profiling.Span._fields)
    with open(tmp_path / "profile" / "trace.json") as f:
        traced = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(SEARCH_SPANS) <= traced
