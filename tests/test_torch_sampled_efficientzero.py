"""Port vs JAX: Sampled EfficientZero, MLP branch (lightzero_tpu_torch/models/
sampled_efficientzero.py and policy/sampled_efficientzero.py against
lightzero_tpu/models/sampled_efficientzero.py and lightzero_tpu/policy/
sampled_efficientzero.py), continuous and discrete, at the small widths of
tests/test_torch_sampled.py with an LSTM of 16 and ``lstm_horizon_len`` 2,
so that the horizon reset happens inside the searches and the unrolls.

- The model method by method, continuous and discrete, the recurrent step
  from a nonzero LSTM state: 1e-5 absolute; the import is exact both ways
  and picks the Sampled EfficientZero map (``_common`` and ``_lstm``).
- The whole search through ``_forward_collect`` with JAX's draws, noise and
  tie_break='first' (as in tests/test_torch_sampled.py): visit counts, the
  trees' children and visit counts, the candidates and the chosen action
  equal, root values 1e-4 relative with a 1e-4 floor; the nodes at depth 2
  and 4 hold a zero LSTM state and accumulator, those at 1 and 3 do not.
- The learn step against the JAX learn step run op by op (why not under
  ``jax.jit``: tests/test_torch_sampled.py), continuous and discrete, with
  ``normalize_prob_of_sampled_actions`` on and off: the logged terms 1e-5
  relative, priorities 1e-5, the params under the criterion of
  tests/test_torch_learn.py; three steps as in tests/test_torch_sampled.py.
- Refusals (the conv model, reanalyze), no GPU without a device, the config
  against the zoo file, and train_muzero on a tiny Pendulum config.
"""
import copy
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightzero_tpu.search as jax_search_module
from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.models.sampled_efficientzero import SampledEfficientZeroModel as JaxSEZModel
from lightzero_tpu.policy.sampled_efficientzero import SampledEfficientZeroPolicy as JaxSEZPolicy
from lightzero_tpu_torch.entry import train_muzero
from lightzero_tpu_torch.models import SampledEfficientZeroModel
from lightzero_tpu_torch.policy import SampledEfficientZeroPolicy
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict, state_dict_to_flax
from test_torch_efficientzero import adam_scale_seen
from test_torch_learn import _check_logs, assert_params_close, gradients_seen
from test_torch_model import perturbed_params
from test_torch_sampled import (
    LEARN_CASES,
    LEARN_IDS,
    _close,
    _values_close,
    as_jax_batch,
    as_port_batch,
    check_search,
    learn_states,
    make_policies,
    policy_cfg,
    random_actions,
    sampled_batch,
    tiny_cfg,
    widths,
)

pytestmark = pytest.mark.unittest

HIDDEN, HORIZON = 16, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sez_cfg(discrete: bool, **override) -> dict:
    cfg = policy_cfg(discrete, lstm_horizon_len=HORIZON, **override)
    cfg["model"] = dict(cfg["model"], lstm_hidden_size=HIDDEN)
    return cfg


def sez_widths(discrete: bool) -> dict:
    return dict(widths(discrete), lstm_hidden_size=HIDDEN)


def test_default_config_is_the_jax_default():
    assert SampledEfficientZeroPolicy.default_config().to_dict() == \
        JaxSEZPolicy.default_config().to_dict()


@pytest.fixture(scope="module", params=[False, True], ids=["continuous", "discrete"])
def models(request):
    discrete = request.param
    flax_model = JaxSEZModel(**sez_widths(discrete))
    params = perturbed_params(flax_model, 0)
    port = SampledEfficientZeroModel(**sez_widths(discrete))
    port.load_state_dict(flax_to_state_dict(params))
    return discrete, flax_model, params, port.eval()


def _check_outputs(got, exp, discrete):
    for field in ("value_logits", "value_prefix_logits", "latent_state"):
        _close(getattr(got, field), exp[field])
    for field in ("policy_logits",) if discrete else ("mu", "sigma"):
        _close(getattr(got, field), exp[field])
    for g, e in zip(got.reward_hidden, exp["reward_hidden"]):  # (c, h) in flax's order
        _close(g, e)


def test_model_matches_flax_method_by_method(models):
    discrete, flax_model, params, port = models
    M = JaxSEZModel
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((6, 3)).astype(np.float32)
    with torch.no_grad():
        exp = flax_model.apply(params, jnp.asarray(obs), method=M.initial_inference)
        got = port.initial_inference(torch.from_numpy(obs))
        _check_outputs(got, exp, discrete)
        assert not got.value_prefix_logits.any() and not got.reward_hidden[1].any()

        latent = np.maximum(rng.standard_normal((6, 16)), 0).astype(np.float32)
        c = rng.standard_normal((6, HIDDEN)).astype(np.float32)
        h = np.tanh(rng.standard_normal((6, HIDDEN))).astype(np.float32)
        action = random_actions(rng, 6, discrete)
        jargs = (jnp.asarray(latent), (jnp.asarray(c), jnp.asarray(h)), jnp.asarray(action))
        targs = (torch.from_numpy(latent), (torch.from_numpy(c), torch.from_numpy(h)),
                 torch.from_numpy(action))
        exp_dyn = flax_model.apply(params, *jargs, method=M.dynamics)
        got_dyn = port.dynamics(*targs)
        _close(got_dyn[0], exp_dyn[0])
        for g, e in zip(got_dyn[1], exp_dyn[1]):
            _close(g, e)
        _close(got_dyn[2], exp_dyn[2])
        exp = flax_model.apply(params, *jargs, method=M.recurrent_inference)
        _check_outputs(port.recurrent_inference(*targs), exp, discrete)
        assert float(np.abs(np.asarray(exp["value_prefix_logits"])).max()) > 0.1  # a live head
        for g, e in zip(port.prediction(targs[0]),
                        flax_model.apply(params, jargs[0], method=M.prediction)):
            _close(g, e)
        for with_grad in (True, False):
            e = flax_model.apply(params, jargs[0], with_grad, method=M.project)
            _close(port.project(targs[0], with_grad), e)


def test_import_is_exact_both_ways(models):
    _, _, params, port = models
    sd = flax_to_state_dict(params)
    assert set(sd) == set(port.state_dict())
    assert "lstm.bias_ih" not in dict(port.named_parameters())
    n_flax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == n_flax
    back = state_dict_to_flax(port.state_dict())
    exp = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(exp)
    for path, leaf in exp:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))
    assert not sd["lstm.bias_ih"].any()


def test_conv_model_and_reanalyze_are_refused():
    # the conv model is ported (tests/test_torch_conv.py); an unknown type is not
    port = SampledEfficientZeroPolicy(dict(model=dict(
        model_type="conv", observation_shape=(6, 6, 3), num_channels=8, downsample=False)),
        device="cpu")
    assert port.model.model_type == "conv"
    with pytest.raises(ValueError, match="model_type"):
        SampledEfficientZeroPolicy(dict(model=dict(model_type="transformer")), device="cpu")
    with pytest.raises(NotImplementedError, match="reanalyze"):
        SampledEfficientZeroPolicy(sez_cfg(False, reanalyze_ratio=0.25), device="cpu")


@pytest.mark.parametrize("discrete,deterministic", [(False, False), (True, True)],
                         ids=["continuous-collect", "discrete-eval"])
def test_forward_collect_searches_as_jax(monkeypatch, discrete, deterministic):
    jax_policy, params, port = make_policies(JaxSEZPolicy, SampledEfficientZeroPolicy,
                                             sez_cfg(discrete, sampled_node_prior="density"),
                                             seed=3)
    # the JAX policy imports the search when it collects
    got, exp, tree, jtree = check_search(jax_policy, params, port, monkeypatch, jax_search_module,
                                         deterministic, discrete)
    assert "collect_mu" not in got and "collect_mu" not in exp
    emb, jemb = tree.embedding, jtree.embedding
    np.testing.assert_array_equal(emb["depth"].numpy(), np.asarray(jemb["depth"]))
    for key in ("latent", "c", "h"):
        _close(emb[key], jemb[key])
    _values_close(emb["vp_accum"], jemb["vp_accum"])
    # the reset ran inside the search: nodes at depth 2 and 4 carry a zero
    # LSTM state and accumulator, nodes at depth 1 and 3 do not
    depth = emb["depth"].numpy()
    expanded = np.arange(depth.shape[1])[None, :] >= 1
    for d, zero in ((1, False), (2, True), (3, False), (4, True)):
        at = expanded & (depth == d)
        if d <= 2:
            assert at.any(), f"no node at depth {d}"
        if at.any():
            assert (np.abs(emb["h"].numpy()[at]).sum(-1) == 0).all() == zero, d
            assert (emb["vp_accum"].numpy()[at] == 0).all() == zero, d


@pytest.fixture(scope="module")
def jax_learners():
    """One JAX policy per case."""
    return {case: JaxSEZPolicy(jax_deep_merge(
        JaxSEZPolicy.default_config(),
        sez_cfg(case[0], normalize_prob_of_sampled_actions=case[1]))) for case in LEARN_CASES}


@pytest.mark.parametrize("case", LEARN_CASES, ids=LEARN_IDS)
def test_learn_step_matches_jax(jax_learners, case):
    discrete, normalize = case
    jax_policy = jax_learners[case]
    port = SampledEfficientZeroPolicy(sez_cfg(discrete, normalize_prob_of_sampled_actions=normalize),
                                      device="cpu")
    jax_state, state = learn_states(jax_policy, port, 0)
    b = sampled_batch(0, discrete)
    seen = gradients_seen(jax_policy, jax_state.params, as_jax_batch(b))
    jax_new, jax_logs, jax_priority = jax_policy._forward_learn(jax_state, as_jax_batch(b))
    new, logs, priority = port.forward_learn(state, as_port_batch(b))
    assert "value_prefix_loss" in logs and "reward_loss" not in logs
    _check_logs(logs, jax_logs)
    np.testing.assert_allclose(priority.numpy(), np.asarray(jax_priority), rtol=1e-5, atol=1e-5)
    assert_params_close(port.model, jax_new.params, seen)


def test_three_learn_steps_with_a_target_copy(jax_learners):
    jax_policy = jax_learners[(True, False)]
    port = SampledEfficientZeroPolicy(sez_cfg(True), device="cpu")
    jax_state, state = learn_states(jax_policy, port, 1)
    seen = None
    for step in range(3):
        b = sampled_batch(10 + step, True)
        seen, held = adam_scale_seen(jax_policy, jax_state.params, as_jax_batch(b), seen)
        jax_state, jax_logs, _ = jax_policy._forward_learn(jax_state, as_jax_batch(b))
        state, logs, _ = port.forward_learn(state, as_port_batch(b))
        _values_close(logs.pop("predicted_value"), jax_logs.pop("predicted_value"))
        _check_logs(logs, jax_logs)
        assert state.train_iter == int(jax_state.train_iter) == step + 1
        assert_params_close(port.model, jax_state.params, held)
        assert_params_close(state.target_model, jax_state.target_params, held)
    assert not state.model.lstm.bias_ih.any()


def test_train_muzero_trains_sampled_efficientzero_on_pendulum_on_the_cpu(tmp_path):
    exp = tmp_path / "exp"
    cfg = tiny_cfg(exp, "sampled_efficientzero", lstm_horizon_len=HORIZON)
    cfg.policy.model = dict(cfg.policy.model, lstm_hidden_size=HIDDEN)
    policy, state, stats = train_muzero(cfg, seed=0, max_train_iter=4, device="cpu")
    assert isinstance(policy, SampledEfficientZeroPolicy)
    assert isinstance(state.model, SampledEfficientZeroModel)
    assert stats["train_iter"] == 4 and stats["env_steps"] == 256
    with open(exp / "log" / "train.jsonl") as f:
        records = [json.loads(line) for line in f]
    learner = [r for r in records if "learner/total_loss" in r]
    assert len(learner) == 2
    for r in learner:
        assert all(math.isfinite(r[f"learner/{k}"]) for k in
                   ("total_loss", "policy_loss", "value_prefix_loss", "consistency_loss"))
    assert not any("collector/collect_sigma" in r for r in records)
    assert os.path.exists(exp / "ckpt" / "ckpt_final.pt")


def test_pendulum_config_raises_with_no_cuda(tmp_path, monkeypatch):
    from lightzero_tpu_torch.configs.pendulum_sampled_efficientzero import main_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = copy.deepcopy(main_config)
    cfg.exp_name = str(tmp_path / "exp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_muzero(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SampledEfficientZeroPolicy(cfg.policy)
    assert not os.path.exists(tmp_path / "exp")


def test_pendulum_config_is_the_zoo_config():
    from lightzero_tpu_torch.configs.pendulum_sampled_efficientzero import main_config
    from zoo.classic_control.pendulum.config.pendulum_sampled_efficientzero_config import (
        main_config as zoo_config,
    )

    assert main_config.to_dict() == JaxConfig(zoo_config).to_dict()
