"""MuZero's learn step as a captured CUDA graph
(lightzero_tpu_torch/policy/learn_graph.py, ``MuZeroPolicy._captured_step``).

On the CPU:
- which steps may be captured (``_graph_key``): MuZero's own loss with SGD
  on a batch on the card; a batch on the CPU, ``grad_sync`` (the DDP
  step), a variant's loss (EfficientZero's, MuZero's multitask) and Adam
  stay eager. The fields of a batch on the card are stand-ins that say so.
- what recaptures (``same_key``): a new training state, an optimizer state
  loaded anew, a moved rate, a batch of another size; the same step again
  matches.
- the steps that stay eager are bitwise the eager step as it stood before
  the graph came (``_before_forward_learn``, a copy kept here): the logs,
  the priorities, the gradients, the parameters, the target copy.
- ``profiling.captured_counts`` and ``profiling.recount``: a capture's
  counts go to its list, and each replay counts them again under a
  profile only.

On the card (marked ``benchmark``, skipped without CUDA): a small conv
MuZero with the SSL loss and SGD, its replayed steps against eager ones
(the logs, the priorities and each step's ``.grad``, then the parameters,
the momentum buffers and the target): with a target copy inside the run,
with a piecewise schedule whose rate moves (an eager step, then a
recapture), with a batch of another size (likewise). In float32 with TF32
off, as the benchmark's cells run, some of cuDNN's convolution gradients
add with atomics, so two eager runs differ in the last bits; with cuDNN's
deterministic algorithms two eager runs agree bit for bit, and so must the
replays with them. The counters (``_build``'s
launches and ``channel_norm.bytes``) equal per replayed and per eager step,
and a replayed step makes no synchronising call
(``torch.cuda.set_sync_debug_mode("warn")``). tests/conftest.py imports
JAX, which the card's machine lacks, so run them there without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_learn_graph.py``.
This file imports no JAX."""
import warnings
from types import SimpleNamespace

import pytest
import torch

from lightzero_tpu_torch import _build
from lightzero_tpu_torch.policy import EfficientZeroPolicy, MuZeroPolicy, learn_graph
from lightzero_tpu_torch.policy.multitask import MuZeroMTPolicy
from lightzero_tpu_torch.policy.muzero import TrainBatch, clip_by_global_norm_, zero_missing_grads_
from lightzero_tpu_torch.utils import profiling

pytestmark = pytest.mark.unittest

A, K = 2, 3
MLP = dict(
    model=dict(observation_shape=4, action_space_size=A, model_type="mlp", latent_state_dim=16,
               support_scale=10, self_supervised_learning_loss=True,
               proj_hid=32, proj_out=32, pred_hid=16, pred_out=32),
    num_unroll_steps=K, batch_size=8, ssl_loss_weight=2, optim_type="SGD", learning_rate=0.2,
    target_update_freq=2,
)


def _batch(obs_shape, A: int, K: int, B: int, seed: int, device="cpu") -> TrainBatch:
    g = torch.Generator().manual_seed(seed)
    mask = (torch.arange(K) < torch.randint(K // 2, K + 1, (B, 1), generator=g)).to(torch.float32)
    policy = torch.softmax(2.0 * torch.randn((B, K + 1, A), generator=g), dim=-1)
    batch = TrainBatch(
        obs=torch.rand((B, K + 1, *obs_shape), generator=g),
        actions=torch.randint(0, A, (B, K), generator=g),
        mask=mask,
        target_reward=torch.randint(-1, 2, (B, K), generator=g).to(torch.float32) * mask,
        target_value=torch.rand((B, K + 1), generator=g) * 4.0 - 2.0,
        target_policy=policy,
        weights=torch.rand((B,), generator=g) * 0.7 + 0.3,
        chance=torch.zeros((B, K), dtype=torch.long),
    )
    return TrainBatch(*(x.to(device) for x in batch))


def _on_card(batch: TrainBatch) -> TrainBatch:
    """Stand-ins for the fields of ``batch`` on the card: the shapes and
    types, and a device that says cuda."""
    return TrainBatch(*(SimpleNamespace(is_cuda=True, shape=x.shape, dtype=x.dtype,
                                        device=torch.device("cuda", 0)) for x in batch))


def _before_forward_learn(policy, state, batch):
    """The eager learn step as it stood before the captured one came
    (``MuZeroPolicy.forward_learn`` with its update tail), kept here."""
    model = state.model
    state.optimizer.zero_grad(set_to_none=True)
    loss, (logs, value_priority) = policy._loss_fn(model, batch)
    loss.backward()
    params = list(model.parameters())
    zero_missing_grads_(params)
    if policy.grad_sync is not None:
        policy.grad_sync(params, logs)
    logs["cur_lr"] = state.lr_scheduler.get_last_lr()[0]
    logs["grad_norm"] = clip_by_global_norm_([p.grad for p in params],
                                             float(policy.cfg.grad_clip_value))
    state.optimizer.step()
    state.lr_scheduler.step()
    train_iter = state.train_iter + 1
    if train_iter % int(policy.cfg.target_update_freq) == 0:
        state.target_model.load_state_dict(state.model.state_dict())
    return state._replace(train_iter=train_iter), logs, value_priority


def _reading(state, logs, priority) -> dict:
    """A step's outcome on the host: its logs and priorities, each
    parameter's gradient and value, the target's parameters, the momentum
    buffers."""
    cpu = lambda t: t.detach().cpu().clone()  # noqa: E731
    named = dict(state.model.named_parameters())
    return dict(
        logs={k: cpu(v) if isinstance(v, torch.Tensor) else torch.tensor(v)
              for k, v in logs.items()},
        priority=cpu(priority),
        grads={k: cpu(p.grad) for k, p in named.items()},
        params={k: cpu(p) for k, p in named.items()},
        target={k: cpu(p) for k, p in state.target_model.named_parameters()},
        momentum={k: cpu(state.optimizer.state[p]["momentum_buffer"])
                  for k, p in named.items() if "momentum_buffer" in state.optimizer.state[p]},
        train_iter=state.train_iter,
    )


def _gap(a: list, b: list) -> float:
    """The largest absolute difference between two runs' readings."""
    worst = 0.0
    for ra, rb in zip(a, b, strict=True):
        assert ra["train_iter"] == rb["train_iter"]
        assert list(ra["logs"]) == list(rb["logs"])
        for part in ("logs", "grads", "params", "target", "momentum"):
            assert ra[part].keys() == rb[part].keys(), part
            for k, x in ra[part].items():
                assert x.shape == rb[part][k].shape and x.dtype == rb[part][k].dtype, (part, k)
                worst = max(worst, float((x.double() - rb[part][k].double()).abs().max()))
        worst = max(worst, float((ra["priority"].double() - rb["priority"].double()).abs().max()))
    return worst


# ------------------------------------------------------------------- CPU

def _one_rank_sync(params, logs) -> None:
    """``grad_sync`` over one rank: each gradient averaged over itself."""
    for p in params:
        p.grad.div_(1.0)


def _policy(kind: str):
    if kind == "efficientzero":
        cfg = dict(MLP, model=dict(MLP["model"], lstm_hidden_size=16))
        return EfficientZeroPolicy(cfg, device="cpu", seed=3)
    if kind == "muzero_multitask":
        return MuZeroMTPolicy(MLP, device="cpu", seed=3)
    cfg = dict(MLP, optim_type="Adam") if kind == "adam" else MLP
    return MuZeroPolicy(cfg, device="cpu", seed=3)


@pytest.mark.parametrize("case, captured", [
    ("muzero with sgd, a batch on the card", True),
    ("a batch on the cpu", False),
    ("grad_sync set", False),
    ("efficientzero's loss", False),
    ("muzero_multitask's loss", False),
    ("adam", False),
])
def test_which_steps_may_be_captured(case, captured):
    kind = {"efficientzero's loss": "efficientzero", "muzero_multitask's loss": "muzero_multitask",
            "adam": "adam"}.get(case, "muzero")
    policy = _policy(kind)
    state = policy.init_train_state()
    batch = _batch((4,), A, K, 8, 0)
    if case != "a batch on the cpu":
        batch = _on_card(batch)
    if case == "grad_sync set":
        policy.grad_sync = _one_rank_sync
    assert (policy._graph_key(state, batch) is not None) == captured


@pytest.mark.parametrize("change, same", [
    ("nothing", True),
    ("a new training state", False),
    ("the optimizer's state loaded anew", False),
    ("the rate moved", False),
    ("another batch size", False),
])
def test_what_recaptures(change, same):
    policy = _policy("muzero")
    state = policy.init_train_state()
    batch = _on_card(_batch((4,), A, K, 8, 0))
    key = policy._graph_key(state, batch)
    if change == "a new training state":
        state = policy.init_train_state()
    elif change == "the optimizer's state loaded anew":
        state.optimizer.load_state_dict(state.optimizer.state_dict())
    elif change == "the rate moved":
        state.optimizer.param_groups[0]["lr"] *= 0.1
    elif change == "another batch size":
        batch = _on_card(_batch((4,), A, K, 6, 0))
    assert learn_graph.same_key(key, policy._graph_key(state, batch)) == same


@pytest.mark.parametrize("case", ["cpu", "grad_sync", "efficientzero"])
def test_eager_steps_are_the_steps_before_the_graph(case):
    """Three steps (a target copy at the second) of the step as it is and
    of the step as it was, from the same weights on the same batches:
    bitwise equal, and nothing captured."""
    runs = []
    for step in (MuZeroPolicy.forward_learn, _before_forward_learn):
        policy = _policy("efficientzero" if case == "efficientzero" else "muzero")
        if case == "grad_sync":
            policy.grad_sync = _one_rank_sync
        state = policy.init_train_state()
        readings = []
        for i in range(3):
            state, logs, priority = step(policy, state, _batch((4,), A, K, 8, i))
            readings.append(_reading(state, logs, priority))
        assert policy._learn_graph is None
        runs.append(readings)
    assert _gap(*runs) == 0.0


def test_a_capture_counts_into_its_list_and_each_replay_counts_again():
    saved = dict(profiling.counters)
    profiling.counters.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.captured_counts() as captured:
                profiling.count("channel_norm.bytes", 64.0)
                profiling.count("moe.tokens_per_expert", torch.tensor([1.0, 2.0]))
            assert profiling.counters == {}
            assert [name for name, _ in captured] == ["channel_norm.bytes",
                                                      "moe.tokens_per_expert"]
            profiling.recount(captured)
            profiling.recount(captured)
        profiling.recount(captured)  # outside a profile: nothing
        assert profiling.counters["channel_norm.bytes"] == [64.0, 64.0]
        tokens = profiling.counters["moe.tokens_per_expert"]
        assert len(tokens) == 2 and tokens[0] is not captured[1][1]
        assert all(torch.equal(t, captured[1][1]) for t in tokens)
    finally:
        profiling.counters.clear()
        profiling.counters.update(saved)


# ------------------------------------------------------------------ card

CONV = dict(
    model=dict(observation_shape=[32, 32, 4], action_space_size=6, model_type="conv",
               num_channels=16, num_res_blocks=1, downsample=True,
               self_supervised_learning_loss=True, support_scale=10, norm_type="BN",
               discrete_action_encoding_type="one_hot", reward_head_hidden_channels=[32],
               value_head_hidden_channels=[32], policy_head_hidden_channels=[32]),
    num_unroll_steps=5, batch_size=8, ssl_loss_weight=2, optim_type="SGD", learning_rate=0.2,
    piecewise_decay_lr_scheduler=False, target_update_freq=100,
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured only on the card")
    return torch.device("cuda")


@pytest.fixture
def deterministic_card():
    """The card in float32 with TF32 off, with cuDNN's deterministic
    algorithms, for the test's duration."""
    _card()
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32
    cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = True, False, False
    yield
    cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = saved


def _conv_batches(sizes, device) -> list:
    return [_batch(CONV["model"]["observation_shape"], 6, 5, B, 100 + i, device)
            for i, B in enumerate(sizes)]


def _run(cfg: dict, batches: list, eager: bool, monkeypatch=None):
    """A fresh policy's learn steps over ``batches``: (the readings, each
    step's mode: "eager", "capture" (captured, then replayed) or
    "replay"). ``eager`` keeps every step eager."""
    policy = MuZeroPolicy(cfg, device="cuda", seed=7)
    if eager:
        policy._captured_step = lambda state, batch: None
    events = []
    if monkeypatch is not None:
        init, replay = learn_graph.LearnGraph.__init__, learn_graph.LearnGraph.replay
        monkeypatch.setattr(learn_graph.LearnGraph, "__init__",
                            lambda self, *a: (events.append("capture"), init(self, *a))[1])
        monkeypatch.setattr(learn_graph.LearnGraph, "replay",
                            lambda self, b: (events.append("replay"), replay(self, b))[1])
    state = policy.init_train_state()
    readings, modes, outputs = [], [], []
    for batch in batches:
        events.clear()
        state, logs, priority = policy.forward_learn(state, batch)
        modes.append(events[0] if events else "eager")
        readings.append(_reading(state, logs, priority))
        outputs.append((logs, priority))
    # what the steps returned, read once every step has run: their own
    for r, (logs, priority) in zip(readings, outputs):
        assert all(torch.equal(r["logs"][k], v.cpu()) for k, v in logs.items()
                   if isinstance(v, torch.Tensor))
        assert torch.equal(r["priority"], priority.cpu())
    return readings, modes


@pytest.mark.benchmark
@pytest.mark.parametrize("case, sizes, cfg, modes", [
    ("a target copy at step 3", [8] * 5, dict(CONV, target_update_freq=3),
     ["eager", "capture", "replay", "replay", "replay"]),
    # the piecewise rate x0.1 from count 2 and again from count 3
    ("a rate that moves", [8] * 7, dict(CONV, piecewise_decay_lr_scheduler=True,
                                        threshold_training_steps_for_final_lr=4),
     ["eager", "capture", "eager", "eager", "capture", "replay", "replay"]),
    ("a batch of another size", [8, 8, 8, 6, 6, 6, 6], CONV,
     ["eager", "capture", "replay", "eager", "capture", "replay", "replay"]),
])
def test_replays_match_eager_steps(case, sizes, cfg, modes, monkeypatch, deterministic_card):
    batches = _conv_batches(sizes, "cuda")
    graphed, seen = _run(cfg, batches, eager=False, monkeypatch=monkeypatch)
    assert seen == modes
    eager, _ = _run(cfg, batches, eager=True)
    again, _ = _run(cfg, batches, eager=True)
    assert _gap(again, eager) == 0.0
    assert _gap(graphed, eager) == 0.0


@pytest.mark.benchmark
def test_a_replay_counts_what_an_eager_step_counts():
    _card()
    policy = MuZeroPolicy(CONV, device="cuda", seed=7)
    state = policy.init_train_state()
    batches = _conv_batches([8] * 3, "cuda")
    saved = dict(profiling.counters)
    per_step = []
    try:
        for batch in batches:
            profiling.counters.clear()
            before = dict(_build.launches)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                state, _, _ = policy.forward_learn(state, batch)
            launches = {k: n - before.get(k, 0) for k, n in _build.launches.items()
                        if n != before.get(k, 0)}
            per_step.append((launches, list(profiling.counters.get("channel_norm.bytes", [])),
                             profiling.counters.get("learn_graph.replays", [])))
    finally:
        profiling.counters.clear()
        profiling.counters.update(saved)
    (eager_l, eager_b, eager_r), captured, replayed = per_step
    assert eager_l["channel_norm_forward"] > 0 and eager_l["channel_norm_backward"] > 0
    assert len(eager_b) == eager_l["channel_norm_forward"] + 2 * eager_l["channel_norm_backward"]
    assert eager_r == []
    for launches, nbytes, replays in (captured, replayed):
        assert launches == eager_l and nbytes == eager_b and replays == [1.0]


@pytest.mark.benchmark
def test_a_replayed_step_does_not_synchronise():
    _card()
    policy = MuZeroPolicy(CONV, device="cuda", seed=7)
    state = policy.init_train_state()
    batches = _conv_batches([8] * 3, "cuda")
    for batch in batches[:2]:
        state, _, _ = policy.forward_learn(state, batch)
    graph = policy._learn_graph
    assert graph is not None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, logs, priority = policy.forward_learn(state, batches[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert policy._learn_graph is graph
    assert [str(w.message) for w in caught if "synchroniz" in str(w.message)] == []
    assert torch.isfinite(logs["total_loss"]) and priority.shape == (8,)
