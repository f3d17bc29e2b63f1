"""Port vs JAX: MuZero-RNN-full-obs, MLP branch
(lightzero_tpu_torch/models/muzero_rnn.py and policy/muzero_rnn_full_obs.py
against lightzero_tpu/models/muzero_rnn.py and
lightzero_tpu/policy/muzero_rnn_full_obs.py), at small widths: latent 16,
GRU 16, supports of 21 atoms (scale 10); the projector has the flax
model's fixed widths. The flax weights are perturbed from a numpy seed and
carried across with utils/params_import.py.

- initial_inference, recurrent_inference from a nonzero history, three
  steps of the history and the projector agree with flax to 1e-5 absolute
  (float32 matmuls, LayerNorm statistics and the GRU's gate sums in another
  order);
- the GRU import is exact both ways, and the port has flax's parameters
  and no others (no recurrent bias on the r and z gates);
- batch_puct_search with the policies' recurrent fns, the same Dirichlet
  noise and tie_break='first', the JAX descent in XLA and through the
  Pallas kernel (interpret mode): visit counts and tree structure equal,
  root values 1e-4 relative with a 1e-4 floor, latents and histories in
  the tree 1e-5;
- three learn steps (target copy at step 2) against the jitted JAX learn
  step: logged terms 1e-5 relative, priorities 1e-5, params by the per-step
  Adam-scale criterion of tests/test_torch_efficientzero.py: 1e-6 where the
  least sqrt(v_t) exceeded 3e-5, 2 lr elsewhere. The share of elements
  held only to 2 lr is bounded per part: at most a quarter outside the
  projector, as in tests/test_torch_learn.py, and at most three quarters in
  the projector. The flax model's projector is fixed at 1024 wide (3.17M of
  the model's 3.18M elements at latent 16), and about two thirds of its
  elements see Adam inputs below 3e-5 from the SSL loss; the projector's
  learn step is held at widths of 64 with the quarter bound in
  tests/test_torch_learn.py;
- train_muzero on a small MuZero-RNN config on the CPU;
- the JAX model cannot be built from the zoo's only MuZero-RNN config
  (Atari, conv, tuple observation shape): ``init_params`` calls int() on
  the tuple (ROADMAP queue 3); the port refuses that config: the JAX model has
  no conv branch to port.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.models.muzero_rnn import MuZeroRNNModel as JaxRNNModel
from lightzero_tpu.ops import inverse_scalar_transform as jax_inverse
from lightzero_tpu.policy.muzero_rnn_full_obs import MuZeroRNNFullObsPolicy as JaxRNNPolicy
from lightzero_tpu.search import batch_puct_search as jax_search
from lightzero_tpu.search.types import RootOutput as JaxRootOutput
from lightzero_tpu.search.types import SearchConfig as JaxSearchConfig
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import train_muzero
from lightzero_tpu_torch.models import MuZeroRNNModel
from lightzero_tpu_torch.ops import inverse_scalar_transform
from lightzero_tpu_torch.policy import MuZeroRNNFullObsPolicy
from lightzero_tpu_torch.search import RootOutput, SearchConfig, batch_puct_search
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict, state_dict_to_flax
from test_torch_efficientzero import _states, adam_scale_seen
from test_torch_learn import (
    LR,
    PARAM_ATOL,
    SMALL_RMS,
    _check_logs,
    as_jax_batch,
    as_port_batch,
    flat,
    random_batch,
)
from test_torch_model import perturbed_params

pytestmark = pytest.mark.unittest

TOL = 1e-5
VALUE_RTOL = VALUE_ATOL = 1e-4
H = 16
WIDTHS = dict(observation_shape=4, action_space_size=2, latent_state_dim=16, rnn_hidden_size=H,
              value_support_size=21, reward_support_size=21)
POLICY = dict(
    model=dict(observation_shape=4, action_space_size=2, model_type="mlp", latent_state_dim=16,
               rnn_hidden_size=H, support_scale=10),
    num_simulations=5, batch_size=16, learning_rate=LR, ssl_loss_weight=2,
    optim_type="Adam", piecewise_decay_lr_scheduler=False, target_update_freq=2,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    flax_model = JaxRNNModel(**WIDTHS)
    params = perturbed_params(flax_model, 0)
    port = MuZeroRNNModel(**WIDTHS)
    port.load_state_dict(flax_to_state_dict(params))
    return flax_model, params, port.eval()


def _close(got, exp, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=tol, atol=tol)


def test_default_config_is_the_jax_default():
    assert (MuZeroRNNFullObsPolicy.default_config().to_dict()
            == JaxRNNPolicy.default_config().to_dict())


def test_initial_and_recurrent_inference_match_flax(models):
    flax_model, params, port = models
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((6, 4)).astype(np.float32)
    exp = flax_model.apply(params, jnp.asarray(obs), method=JaxRNNModel.initial_inference)
    with torch.no_grad():
        got = port.initial_inference(torch.from_numpy(obs))
    for field in ("value_logits", "reward_logits", "policy_logits", "history"):
        _close(getattr(got, field), exp[field])
    _close(got.latent_state, exp["latent_state"])
    assert not got.history.any() and not got.reward_logits.any()
    # three recurrent steps from a nonzero history: the history evolves
    latent = got.latent_state
    history = torch.from_numpy(np.tanh(rng.standard_normal((6, H))).astype(np.float32))
    jlatent, jhistory = exp["latent_state"], jnp.asarray(history.numpy())
    for step in range(3):
        action = rng.integers(0, 2, 6).astype(np.int32)
        exp = flax_model.apply(params, jlatent, jhistory, jnp.asarray(action),
                               method=JaxRNNModel.recurrent_inference)
        with torch.no_grad():
            got = port.recurrent_inference(latent, history, torch.from_numpy(action))
        for field in ("value_logits", "reward_logits", "policy_logits", "latent_state", "history"):
            _close(getattr(got, field), exp[field])
        assert not torch.allclose(got.history, history)
        assert float(np.abs(np.asarray(exp["reward_logits"])).max()) > 0.1  # a live head
        latent, history = got.latent_state, got.history
        jlatent, jhistory = exp["latent_state"], exp["history"]
    for with_grad in (True, False):
        e = flax_model.apply(params, jlatent, with_grad, method=JaxRNNModel.project)
        with torch.no_grad():
            _close(port.project(latent, with_grad), e)


def test_gru_import_is_exact_both_ways(models):
    _, params, port = models
    sd = flax_to_state_dict(params)
    assert set(sd) == set(port.state_dict()) == set(dict(port.named_parameters()))
    n_flax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == n_flax
    gru = params["params"]["_gru"]
    assert set(gru) == {"ir", "iz", "in", "hr", "hz", "hn"}
    for k, gate in enumerate("rzn"):
        rows = slice(H * k, H * (k + 1))
        np.testing.assert_array_equal(sd["gru.weight_ih"][rows].numpy(), gru[f"i{gate}"]["kernel"].T)
        np.testing.assert_array_equal(sd["gru.bias_ih"][rows].numpy(), gru[f"i{gate}"]["bias"])
        np.testing.assert_array_equal(sd["gru.weight_hh"][rows].numpy(), gru[f"h{gate}"]["kernel"].T)
    np.testing.assert_array_equal(sd["gru.bias_hn"].numpy(), gru["hn"]["bias"])
    back = state_dict_to_flax(port.state_dict())
    exp = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(exp)
    for path, leaf in exp:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))


def test_gru_import_refuses_what_it_does_not_know(models):
    import copy

    _, params, _ = models
    bad = copy.deepcopy(params)
    bad["params"]["_gru"]["hr"]["bias"] = np.zeros(H, np.float32)
    with pytest.raises(KeyError, match="_gru/hr/bias"):
        flax_to_state_dict(bad)
    with pytest.raises(KeyError, match="gru.bias_hh"):
        state_dict_to_flax({"gru.bias_hh": torch.zeros(3 * H)})


def test_default_init_is_flax_like():
    port = MuZeroRNNModel(**WIDTHS, generator=torch.Generator().manual_seed(0))
    w_hh = port.gru.weight_hh.detach()
    for k in range(3):  # each gate's recurrent kernel orthogonal
        q = w_hh[H * k:H * (k + 1)]
        torch.testing.assert_close(q @ q.T, torch.eye(H), rtol=0, atol=1e-5)
    assert not port.gru.bias_ih.any() and not port.gru.bias_hn.any()
    for head in (port.reward_head, port.value_head, port.policy_head):
        assert not head.dense[-1].weight.any()


@pytest.fixture(scope="module")
def jax_policy():
    """One JAX policy (one jit of its learn step), the target copied every
    2 steps."""
    return JaxRNNPolicy(jax_deep_merge(JaxRNNPolicy.default_config(), POLICY))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_search_matches_jax(jax_policy, use_pallas):
    port = MuZeroRNNFullObsPolicy(POLICY, device="cpu")
    params = perturbed_params(jax_policy.model, 3)
    port.model.load_state_dict(flax_to_state_dict(params))
    B, A, sims = 6, 2, 16
    rng = np.random.default_rng(4)
    obs = rng.standard_normal((B, 4)).astype(np.float32)
    legal = np.ones((B, A), bool)
    noise = rng.dirichlet(np.full(A, 0.3), B).astype(np.float32)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    out0 = jax_policy._initial(jparams, jnp.asarray(obs))
    jroot = JaxRootOutput(prior_logits=out0.policy_logits,
                          value=jax_inverse(out0.value_logits, jax_policy.value_support),
                          embedding=jax_policy._root_embedding(out0))
    jcfg = JaxSearchConfig(num_simulations=sims, tie_break="first", use_pallas_traverse=use_pallas)
    exp = jax_search(jparams, jax.random.PRNGKey(0), jroot, jax_policy._recurrent_fn, jcfg,
                     jnp.asarray(legal), to_play=jnp.full((B,), -1, jnp.int32),
                     noise=jnp.asarray(noise))
    with torch.no_grad():
        o0 = port.model.initial_inference(torch.from_numpy(obs))
        root = RootOutput(prior_logits=o0.policy_logits,
                          value=inverse_scalar_transform(o0.value_logits, port.value_support),
                          embedding=port._root_embedding(o0))
    got = batch_puct_search(root, functools.partial(port._recurrent_fn, port.model),
                            SearchConfig(num_simulations=sims, tie_break="first"),
                            torch.from_numpy(legal), noise=torch.from_numpy(noise), device="cpu")
    np.testing.assert_array_equal(got.visit_counts.numpy(), np.asarray(exp.visit_counts))
    np.testing.assert_array_equal(got.tree.children.numpy(), np.asarray(exp.tree.children))
    np.testing.assert_allclose(got.root_value.numpy(), np.asarray(exp.root_value),
                               rtol=VALUE_RTOL, atol=VALUE_ATOL)
    np.testing.assert_allclose(got.tree.value_sum.numpy(), np.asarray(exp.tree.value_sum),
                               rtol=VALUE_RTOL, atol=VALUE_ATOL)
    for key in ("latent", "history"):
        _close(got.tree.embedding[key], exp.tree.embedding[key])
    assert got.tree.embedding["history"][:, 1:].abs().sum() > 0  # histories evolved in the tree


def assert_params_close(port_model, jax_params, held):
    """tests/test_torch_learn.py's criterion with the bound on the share of
    elements held only to 2 lr taken per part: a quarter outside the
    projector, three quarters in it (see the module docstring)."""
    got = flat(state_dict_to_flax(port_model.state_dict()))
    exp = flat(jax_params)
    assert set(got) == set(exp)
    sumsq, steps = held
    counts = {True: [0, 0], False: [0, 0]}  # in the projector: [sensitive, total]
    for k in exp:
        sensitive = np.sqrt(sumsq[k] / steps) <= SMALL_RMS
        np.testing.assert_allclose(got[k][~sensitive], exp[k][~sensitive], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=2 * LR, err_msg=k)
        part = counts["/_proj/" in k]
        part[0] += int(sensitive.sum())
        part[1] += sensitive.size
    assert counts[False][0] <= counts[False][1] // 4, counts
    assert counts[True][0] <= 3 * counts[True][1] // 4, counts


def test_three_learn_steps_with_a_target_copy(jax_policy):
    port = MuZeroRNNFullObsPolicy(POLICY, device="cpu")
    jax_state, state = _states(jax_policy, port, 1)
    seen = None
    for step in range(3):
        b = random_batch(20 + step)
        seen, held = adam_scale_seen(jax_policy, jax_state.params, as_jax_batch(b), seen)
        jax_state, jax_logs, jax_priority = jax_policy.forward_learn(jax_state, as_jax_batch(b))
        state, logs, priority = port.forward_learn(state, as_port_batch(b))
        _check_logs(logs, jax_logs)
        assert float(jax_logs["consistency_loss"]) != 0.0  # the SSL branch ran
        np.testing.assert_allclose(priority.numpy(), np.asarray(jax_priority), rtol=1e-5,
                                   atol=1e-5)
        assert state.train_iter == int(jax_state.train_iter) == step + 1
        assert_params_close(port.model, jax_state.params, held)
        assert_params_close(state.target_model, jax_state.target_params, held)


def tiny_cfg(exp_dir):
    return Config(dict(
        exp_name=str(exp_dir),
        env=dict(env_id="CartPole-v0", stop_value=10_000, collector_env_num=2,
                 evaluator_env_num=2, n_evaluator_episode=2),
        policy=dict(type="muzero_rnn_full_obs", model=POLICY["model"], num_simulations=5,
                    batch_size=16, update_per_collect=4, n_episode=2, eval_freq=1000,
                    reanalyze_ratio=0.25),
    ))


def test_train_muzero_trains_muzero_rnn_on_the_cpu(tmp_path):
    exp = tmp_path / "exp"
    policy, state, stats = train_muzero(tiny_cfg(exp), seed=0, max_env_step=200, device="cpu")
    assert isinstance(policy, MuZeroRNNFullObsPolicy) and isinstance(state.model, MuZeroRNNModel)
    assert stats["env_steps"] == 256 and stats["train_iter"] == 8
    with open(exp / "log" / "train.jsonl") as f:
        learner = [r for r in map(json.loads, f) if "learner/total_loss" in r]
    assert len(learner) == 2
    for r in learner:
        assert np.isfinite(r["learner/total_loss"]) and r["learner/consistency_loss"] != 0.0


def test_the_zoo_rnn_config_fails_in_jax_and_is_refused_by_the_port():
    """The zoo's only MuZero-RNN config is Atari's (conv, observations
    (96, 96, 12)): the JAX model's from_config ignores model_type and
    init_params calls int() on the tuple (ROADMAP queue 3); the port
    refuses it: there is no conv branch to port."""
    from zoo.atari.config.atari_muzero_rnn_fullobs_config import main_config

    model = JaxRNNModel.from_config(main_config.policy.model)
    with pytest.raises(TypeError, match="int\\(\\) argument"):
        model.init_params(jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="no conv branch"):
        MuZeroRNNFullObsPolicy(main_config.policy.to_dict(), device="cpu")
