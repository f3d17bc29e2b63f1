"""Port vs JAX: EfficientZero, MLP branch (lightzero_tpu_torch/models/efficientzero.py
and policy/efficientzero.py against lightzero_tpu/models/efficientzero.py and
lightzero_tpu/policy/efficientzero.py), at small widths: latent 16, LSTM 16,
projector 64, supports of 21 atoms (scale 10). The flax weights are
perturbed from a numpy seed (the flax init zeroes the heads' last layers)
and carried across with utils/params_import.py.

- initial_inference, recurrent_inference (from a nonzero LSTM state) and
  the projector agree with flax to 1e-5 (float32 matmuls, LayerNorm
  statistics and the LSTM's gate sums in another order);
- the LSTM import is exact both ways: flax -> port -> flax gives back every
  leaf bit for bit, and the port's gate rows are flax's transposed kernels
  in the order i, f, g, o;
- batch_puct_search with the policies' EfficientZero recurrent_fn at
  lstm_horizon_len=2, the same Dirichlet noise and tie_break='first', with
  the JAX descent in XLA and through the Pallas kernel (interpret mode):
  visit counts and tree structure equal, root values 1e-5, the latents and
  LSTM states in the tree 1e-5, and the horizon reset reached inside the
  search (depth 2 and 4 nodes with a zero LSTM state). The per-node
  rewards, value sums, accumulators and the root children's Q agree to
  1e-4: a reward is vp - vp_accum, a difference of two inverse-transformed
  values, and the inverse transform's cancellation already costs 1e-4
  relative (tests/test_torch_ops.py);
- one learn step (horizons 5 and 2) and three steps (horizon 2, target copy
  at step 2) against the jitted JAX learn step, under the criteria of
  tests/test_torch_learn.py: logged terms 1e-5 relative, priorities 1e-5,
  params 1e-6 absolute where Adam's input is above 3e-5 and 2 lr elsewhere
  (at most a quarter of the elements). Over several steps the input's scale
  is taken at each step, as the bias-corrected second moment sqrt(v_t) that
  divides that step's update: an element is held to 1e-6 only where it
  exceeded 3e-5 at every step. (The RMS over all steps, which
  tests/test_torch_learn.py uses, hides a step whose gradient was near
  zero: here an element with Adam inputs 7.8e-9, 2.8e-5 and 6.7e-5 took
  its first update of about lr sign(g) from a gradient at the rounding
  level, and differed by 3.2e-6 after three steps.)
- train_muzero on a tiny EfficientZero config on the CPU; and, with no GPU
  and no device, it raises on the CartPole EfficientZero config.
"""
import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.models.efficientzero import EfficientZeroModel as JaxEZModel
from lightzero_tpu.policy.efficientzero import EfficientZeroPolicy as JaxEZPolicy
from lightzero_tpu.policy.muzero import TrainState as JaxTrainState
from lightzero_tpu.search import batch_puct_search as jax_search
from lightzero_tpu.search.types import RootOutput as JaxRootOutput
from lightzero_tpu.search.types import SearchConfig as JaxSearchConfig
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import train_muzero
from lightzero_tpu_torch.models import EfficientZeroModel
from lightzero_tpu_torch.policy import EfficientZeroPolicy
from lightzero_tpu_torch.search import RootOutput, SearchConfig, batch_puct_search
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict, state_dict_to_flax
from test_torch_learn import (
    LR,
    _check_logs,
    as_jax_batch,
    as_port_batch,
    assert_params_close,
    gradients_seen,
    random_batch,
)
from test_torch_model import perturbed_params

pytestmark = pytest.mark.unittest

TOL = 1e-5
TREE_TOL = 1e-4
WIDTHS = dict(observation_shape=4, action_space_size=2, latent_state_dim=16, lstm_hidden_size=16,
              value_support_size=21, reward_support_size=21,
              proj_hid=64, proj_out=64, pred_hid=32, pred_out=64)
POLICY = dict(
    model=dict(observation_shape=4, action_space_size=2, model_type="mlp", latent_state_dim=16,
               lstm_hidden_size=16, support_scale=10),
    num_simulations=5, batch_size=16, learning_rate=LR, ssl_loss_weight=2,
    optim_type="Adam", piecewise_decay_lr_scheduler=False,
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
    flax_model = JaxEZModel(**WIDTHS)
    params = perturbed_params(flax_model, 0)
    port = EfficientZeroModel(**WIDTHS)
    port.load_state_dict(flax_to_state_dict(params))
    return flax_model, params, port.eval()


def _close(got, exp, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=tol, atol=tol)


def test_default_config_is_the_jax_default():
    assert EfficientZeroPolicy.default_config().to_dict() == JaxEZPolicy.default_config().to_dict()


def test_initial_inference_matches_flax(models):
    flax_model, params, port = models
    obs = np.random.default_rng(1).standard_normal((6, 4)).astype(np.float32)
    exp = flax_model.apply(params, jnp.asarray(obs), method=JaxEZModel.initial_inference)
    with torch.no_grad():
        got = port.initial_inference(torch.from_numpy(obs))
    for field in ("value_logits", "value_prefix_logits", "policy_logits", "latent_state"):
        _close(getattr(got, field), getattr(exp, field))
    assert not got.value_prefix_logits.any() and got.value_prefix_logits.shape == (6, 21)
    for g, e in zip(got.reward_hidden, exp.reward_hidden):  # (c, h), zero
        assert g.shape == (6, 16) and not g.any()
        _close(g, e)


def test_recurrent_inference_matches_flax(models):
    flax_model, params, port = models
    rng = np.random.default_rng(2)
    latent = np.maximum(rng.standard_normal((6, 16)), 0).astype(np.float32)
    c = rng.standard_normal((6, 16)).astype(np.float32)
    h = np.tanh(rng.standard_normal((6, 16))).astype(np.float32)
    action = rng.integers(0, 2, 6).astype(np.int32)
    exp = flax_model.apply(params, jnp.asarray(latent), (jnp.asarray(c), jnp.asarray(h)),
                           jnp.asarray(action), method=JaxEZModel.recurrent_inference)
    with torch.no_grad():
        got = port.recurrent_inference(torch.from_numpy(latent),
                                       (torch.from_numpy(c), torch.from_numpy(h)),
                                       torch.from_numpy(action))
    for field in ("value_logits", "value_prefix_logits", "policy_logits", "latent_state"):
        _close(getattr(got, field), getattr(exp, field))
    assert float(np.abs(np.asarray(exp.value_prefix_logits)).max()) > 0.1  # a live head
    for g, e in zip(got.reward_hidden, exp.reward_hidden):  # (c', h') in flax's order
        _close(g, e)
    for with_grad in (True, False):
        e = flax_model.apply(params, jnp.asarray(latent), with_grad, method=JaxEZModel.project)
        with torch.no_grad():
            _close(port.project(torch.from_numpy(latent), with_grad), e)


def test_lstm_import_is_exact_both_ways(models):
    _, params, port = models
    sd = flax_to_state_dict(params)
    assert set(sd) == set(port.state_dict())
    # bias_ih is a zero buffer: the parameters are exactly flax's
    assert "lstm.bias_ih" not in dict(port.named_parameters())
    n_flax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == n_flax
    lstm = params["params"]["_lstm"]
    for k, gate in enumerate("ifgo"):
        rows = slice(16 * k, 16 * (k + 1))
        np.testing.assert_array_equal(sd["lstm.weight_ih"][rows].numpy(), lstm[f"i{gate}"]["kernel"].T)
        np.testing.assert_array_equal(sd["lstm.weight_hh"][rows].numpy(), lstm[f"h{gate}"]["kernel"].T)
        np.testing.assert_array_equal(sd["lstm.bias_hh"][rows].numpy(), lstm[f"h{gate}"]["bias"])
    assert not sd["lstm.bias_ih"].any()
    back = state_dict_to_flax(port.state_dict())
    exp = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(exp)
    for path, leaf in exp:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))


def test_lstm_import_refuses_what_flax_cannot_hold(models):
    _, params, port = models
    bad = copy.deepcopy(params)
    bad["params"]["_lstm"]["ii"]["bias"] = np.zeros(16, np.float32)
    with pytest.raises(KeyError, match="_lstm/ii/bias"):
        flax_to_state_dict(bad)
    sd = dict(port.state_dict(), **{"lstm.bias_ih": torch.ones(64)})
    with pytest.raises(ValueError, match="bias_ih"):
        state_dict_to_flax(sd)
    with pytest.raises(KeyError, match="lstm.weight_xx"):
        state_dict_to_flax({"lstm.weight_xx": torch.zeros(64, 16)})


def test_default_init_is_flax_like():
    port = EfficientZeroModel(**WIDTHS, generator=torch.Generator().manual_seed(0))
    assert port.value_prefix_norm.eps == 1e-6
    assert not port.value_prefix_head.dense[-1].weight.any()
    w_hh = port.lstm.weight_hh.detach()
    for k in range(4):  # each gate's recurrent kernel orthogonal
        q = w_hh[16 * k:16 * (k + 1)]
        torch.testing.assert_close(q @ q.T, torch.eye(16), rtol=0, atol=1e-5)
    assert not port.lstm.bias_hh.any() and not port.lstm.bias_ih.any()


def test_conv_model_is_refused():
    """The conv model is ported (tests/test_torch_conv.py holds it against
    flax): the policy builds it on image observations; a model type the JAX
    package does not know is refused."""
    port = EfficientZeroPolicy(dict(model=dict(model_type="conv", observation_shape=(6, 6, 3),
                                               num_channels=8, downsample=False,
                                               lstm_hidden_size=16)), device="cpu")
    assert port.model.model_type == "conv" and port.model.lstm.input_size == 6 * 6 * 16
    with pytest.raises(ValueError, match="model_type"):
        EfficientZeroPolicy(dict(model=dict(model_type="transformer")), device="cpu")


@pytest.fixture(scope="module")
def jax_policies():
    """One JAX policy per horizon (one jit of its learn step each), the
    target copied every 2 steps."""
    return {h: JaxEZPolicy(jax_deep_merge(JaxEZPolicy.default_config(),
                                          dict(POLICY, lstm_horizon_len=h, target_update_freq=2)),
                           model=JaxEZModel(**WIDTHS))
            for h in (5, 2)}


def _policies(jax_policies, horizon):
    """The JAX policy and a fresh port policy on the same small model."""
    cfg = dict(POLICY, lstm_horizon_len=horizon, target_update_freq=2)
    port = EfficientZeroPolicy(cfg, model=EfficientZeroModel(**WIDTHS), device="cpu")
    return jax_policies[horizon], port


@pytest.mark.parametrize("use_pallas", [False, True])
def test_search_with_a_horizon_reset_matches_jax(jax_policies, use_pallas):
    jax_policy, port = _policies(jax_policies, 2)
    params = perturbed_params(jax_policy.model, 3)
    port.model.load_state_dict(flax_to_state_dict(params))
    B, A, sims = 6, 2, 16
    rng = np.random.default_rng(4)
    obs = rng.standard_normal((B, 4)).astype(np.float32)
    legal = np.ones((B, A), bool)
    noise = rng.dirichlet(np.full(A, 0.3), B).astype(np.float32)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    out0 = jax_policy._initial(jparams, jnp.asarray(obs))
    from lightzero_tpu.ops import inverse_scalar_transform as jax_inverse
    jroot = JaxRootOutput(prior_logits=out0.policy_logits,
                          value=jax_inverse(out0.value_logits, jax_policy.value_support),
                          embedding=jax_policy._root_embedding(out0))
    jcfg = JaxSearchConfig(num_simulations=sims, tie_break="first", use_pallas_traverse=use_pallas)
    exp = jax_search(jparams, jax.random.PRNGKey(0), jroot, jax_policy._recurrent_fn, jcfg,
                     jnp.asarray(legal), to_play=jnp.full((B,), -1, jnp.int32),
                     noise=jnp.asarray(noise))

    with torch.no_grad():
        o0 = port.model.initial_inference(torch.from_numpy(obs))
        from lightzero_tpu_torch.ops import inverse_scalar_transform
        root = RootOutput(prior_logits=o0.policy_logits,
                          value=inverse_scalar_transform(o0.value_logits, port.value_support),
                          embedding=port._root_embedding(o0))
    got = batch_puct_search(root, functools.partial(port._recurrent_fn, port.model),
                            SearchConfig(num_simulations=sims, tie_break="first"),
                            torch.from_numpy(legal), noise=torch.from_numpy(noise), device="cpu")

    np.testing.assert_array_equal(got.visit_counts.numpy(), np.asarray(exp.visit_counts))
    np.testing.assert_array_equal(got.tree.children.numpy(), np.asarray(exp.tree.children))
    _close(got.root_value, exp.root_value)
    _close(got.root_children_values, exp.root_children_values, TREE_TOL)
    _close(got.tree.value_sum, exp.tree.value_sum, TREE_TOL)
    _close(got.tree.reward, exp.tree.reward, TREE_TOL)
    emb, jemb = got.tree.embedding, exp.tree.embedding
    np.testing.assert_array_equal(emb["depth"].numpy(), np.asarray(jemb["depth"]))
    for key in ("latent", "c", "h"):
        _close(emb[key], jemb[key])
    _close(emb["vp_accum"], jemb["vp_accum"], TREE_TOL)
    # the reset ran inside the search: expanded nodes at depth 2 and 4 carry
    # a zero LSTM state and accumulator, nodes at depth 1 and 3 do not
    depth = emb["depth"].numpy()
    expanded = np.arange(sims + 1)[None, :] >= 1
    for d, zero in ((1, False), (2, True), (3, False), (4, True)):
        at = expanded & (depth == d)
        assert at.any(), f"no node at depth {d}"
        assert (np.abs(emb["h"].numpy()[at]).sum(-1) == 0).all() == zero, d
        assert (emb["vp_accum"].numpy()[at] == 0).all() == zero, d


def adam_scale_seen(jax_policy, params, batch, seen=None):
    """Adds one step to ``seen`` = (second-moment EMA by parameter, steps,
    least sqrt(v_t) so far) and returns it with the least scale as
    ``assert_params_close`` takes it: (scale squared, 1)."""
    sq, _ = gradients_seen(jax_policy, params, batch)
    b2 = 0.999  # optax.adam's default, as the JAX policy builds it
    ema, steps, least = seen if seen is not None else ({k: 0.0 for k in sq}, 0, None)
    steps += 1
    ema = {k: b2 * ema[k] + (1 - b2) * sq[k] for k in sq}
    scale = {k: np.sqrt(ema[k] / (1 - b2 ** steps)) for k in sq}
    least = scale if least is None else {k: np.minimum(least[k], scale[k]) for k in sq}
    return (ema, steps, least), ({k: v ** 2 for k, v in least.items()}, 1)


def _states(jax_policy, port, seed):
    params = perturbed_params(jax_policy.model, seed)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jax_state = JaxTrainState(
        params=params,
        target_params=jax.tree_util.tree_map(jnp.copy, params),
        opt_state=jax_policy.optimizer.init(params),
        train_iter=jnp.zeros((), jnp.int32),
    )
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jax_state, port.init_train_state()


@pytest.mark.parametrize("horizon", [5, 2])
def test_learn_step_matches_jax(jax_policies, horizon):
    jax_policy, port = _policies(jax_policies, horizon)
    jax_state, state = _states(jax_policy, port, 0)
    b = random_batch(0)
    seen = gradients_seen(jax_policy, jax_state.params, as_jax_batch(b))
    jax_new, jax_logs, jax_priority = jax_policy.forward_learn(jax_state, as_jax_batch(b))
    new, logs, priority = port.forward_learn(state, as_port_batch(b))
    assert "value_prefix_loss" in logs and "reward_loss" not in logs
    _check_logs(logs, jax_logs)
    assert float(jax_logs["consistency_loss"]) != 0.0  # the SSL branch ran
    np.testing.assert_allclose(priority.numpy(), np.asarray(jax_priority), rtol=1e-5, atol=1e-5)
    assert new.train_iter == 1
    assert_params_close(port.model, jax_new.params, seen)


def test_three_learn_steps_with_a_target_copy(jax_policies):
    jax_policy, port = _policies(jax_policies, 2)
    jax_state, state = _states(jax_policy, port, 1)
    seen = None
    for step in range(3):
        b = random_batch(10 + step)
        seen, held = adam_scale_seen(jax_policy, jax_state.params, as_jax_batch(b), seen)
        jax_state, jax_logs, _ = jax_policy.forward_learn(jax_state, as_jax_batch(b))
        state, logs, _ = port.forward_learn(state, as_port_batch(b))
        _check_logs(logs, jax_logs)
        assert state.train_iter == int(jax_state.train_iter) == step + 1
        assert_params_close(port.model, jax_state.params, held)
        assert_params_close(state.target_model, jax_state.target_params, held)
    assert not state.model.lstm.bias_ih.any()


def tiny_cfg(exp_dir):
    return Config(dict(
        exp_name=str(exp_dir),
        env=dict(env_id="CartPole-v0", stop_value=10_000, collector_env_num=2,
                 evaluator_env_num=2, n_evaluator_episode=2),
        policy=dict(type="efficientzero", model=POLICY["model"], num_simulations=5,
                    batch_size=16, update_per_collect=4, n_episode=2, eval_freq=1000,
                    lstm_horizon_len=2, reanalyze_ratio=0.25),
    ))


def test_train_muzero_trains_efficientzero_on_the_cpu(tmp_path):
    exp = tmp_path / "exp"
    policy, state, stats = train_muzero(tiny_cfg(exp), seed=0, max_env_step=200, device="cpu")
    assert isinstance(policy, EfficientZeroPolicy) and isinstance(state.model, EfficientZeroModel)
    assert stats["env_steps"] == 256 and stats["train_iter"] == 8
    with open(exp / "total_config.json") as f:
        saved = json.load(f)["policy"]
    assert saved["type"] == "efficientzero" and saved["lstm_horizon_len"] == 2
    with open(exp / "log" / "train.jsonl") as f:
        learner = [r for r in map(json.loads, f) if "learner/total_loss" in r]
    assert len(learner) == 2
    for r in learner:
        assert np.isfinite(r["learner/total_loss"]) and np.isfinite(r["learner/value_prefix_loss"])
    assert os.path.exists(exp / "ckpt" / "ckpt_final.pt")


def test_train_muzero_on_the_cartpole_config_raises_with_no_cuda(tmp_path, monkeypatch):
    from lightzero_tpu_torch.configs.cartpole_efficientzero import main_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = copy.deepcopy(main_config)
    cfg.exp_name = str(tmp_path / "exp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_muzero(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EfficientZeroPolicy(cfg.policy)
    assert not os.path.exists(tmp_path / "exp")


def test_cartpole_config_is_the_zoo_config():
    from lightzero_tpu_torch.configs.cartpole_efficientzero import main_config
    from zoo.classic_control.cartpole.config.cartpole_efficientzero_config import (
        main_config as zoo_config,
    )

    assert main_config.to_dict() == JaxConfig(zoo_config).to_dict()
