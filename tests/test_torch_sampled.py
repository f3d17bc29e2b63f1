"""Port vs JAX: Sampled MuZero, MLP branch (lightzero_tpu_torch/models/
sampled_muzero.py and policy/sampled_muzero.py against
lightzero_tpu/models/sampled_muzero.py and lightzero_tpu/policy/
sampled_muzero.py), continuous (Pendulum's observation 3, action dimension
1) and discrete (6 actions), at small widths: latent 16, K = 3 candidates,
supports of 11 atoms (scale 5), 6 simulations, 3 unroll steps. The flax weights are
perturbed from a numpy seed (the flax init zeroes the heads' last layers)
and carried across with utils/params_import.py.

- The sampling functions on the same inputs and the same draws:
  ``gaussian_tanh_sample`` with injected normals, both prior spaces, 1e-5
  relative. In the 'squashed' space the log-weights add
  -log(1 - a^2 + 1e-6) at a = tanh(x), where an error d in a moves them by
  2|a| d / (1 - a^2 + 1e-6): XLA's float32 tanh is off by up to 4.3 ulp
  near saturation (torch's by 0.56, both against float64 on 2e5 points in
  [-9, 9]), so there the bound adds that sensitivity times 5 ulp of a.
  ``gaussian_tanh_logp`` 1e-5 relative, actions near +-1 included
  (clipped to 1 - 1e-6, where arctanh and log(1 - a^2 + 1e-6) amplify the
  last bit of a: the two agree there too, since both round the same float32
  ops); ``sample_discrete_actions`` with injected Gumbels: actions exactly
  equal, log-probs 1e-6; ``sampled_search_prior`` in both modes.
- The model method by method, continuous and discrete: 1e-5 absolute; the
  import is exact both ways and picks the sampled map.
- The whole search through ``_forward_collect``: the root's and every
  simulation's draws rebuilt from JAX's key splits (policy/
  sampled_muzero.py:195, then search/puct.py:781,789), the same Dirichlet
  noise (rebuilt from the search's key), tie_break='first', in collect and
  eval mode, with the uniform and the density prior: visit counts, the
  trees' children and visit counts, the candidates and the chosen action
  equal, and the K-slot embedding ``sampled_actions`` (B, N, K, D) of every
  node as JAX's pytree holds it (init_tree, map_embedding and
  _expand_and_backup carry it unchanged); root values within 1e-4 relative with a 1e-4 floor (ROADMAP queue
  3: the 11-atom value expectation is summed in another order).
- The learn step against the JAX learn step (``_forward_learn``), continuous
  and discrete, with ``normalize_prob_of_sampled_actions`` on and off: the
  logged terms 1e-5 relative, priorities 1e-5, the params under the
  criterion of tests/test_torch_learn.py; three steps (target copy at step
  2) under the per-step Adam-scale criterion of
  tests/test_torch_efficientzero.py, the logged terms 1e-5 relative, but
  the mean predicted value: the params that go into steps 2 and 3 already
  differ within that criterion (2e-5 at ~30 rounding-sensitive elements),
  and the value is h^-1 of an 11-atom expectation, so it is held as the
  searches' values are, 1e-4 relative with a 1e-4 floor. The JAX step runs op by op, not under
  ``jax.jit``: the batches hold stored candidates at +-1 (tanh rounds to 1
  in float32 from x = 9), and there XLA's compiled loss rewrites
  log(1 - a^2 + 1e-6) as log((1 + 1e-6) - a^2), and 1 + 1e-6 rounds to
  1.00000095 in float32: -12.7235 where the formula as written gives
  -12.7081 (float64: -12.70808), 1.8e-4 of the continuous policy loss.
  The term does not depend on the params, so the gradients do not see it;
  op by op, JAX evaluates its formula as written, and the port agrees with
  it to ~1e-7.
- Refusals: an unknown model type and reanalyze, which the JAX policy
  cannot run (tests/test_torch_train.py shows its AttributeError); without
  a GPU and a device the policy and train_muzero raise.
- The collector stores float actions and the root candidates; the buffer's
  sampled batch equals JAX's on the same episodes and numpy seed;
  train_muzero on a tiny Pendulum config on the CPU.
"""
import copy
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.buffers.game_buffer import EpisodeRecord as JaxEpisodeRecord
from lightzero_tpu.buffers.game_buffer import GameBuffer as JaxGameBuffer
from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.models.sampled_muzero import SampledMuZeroModel as JaxSMZModel
from lightzero_tpu.policy import sampled_muzero as jax_smz
from lightzero_tpu.policy.muzero import TrainBatch as JaxTrainBatch
from lightzero_tpu.policy.muzero import TrainState as JaxTrainState
from lightzero_tpu_torch.buffers import EpisodeRecord, GameBuffer
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import train_muzero
from lightzero_tpu_torch.envs import PendulumEnv
from lightzero_tpu_torch.models import SampledMuZeroModel
from lightzero_tpu_torch.policy import SampledMuZeroPolicy
from lightzero_tpu_torch.policy import sampled_muzero as smz
from lightzero_tpu_torch.policy.muzero import TrainBatch
from lightzero_tpu_torch.policy.sampled_muzero import SampledTrainBatch
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict, state_dict_to_flax
from lightzero_tpu_torch.workers import RolloutCollector
from test_torch_efficientzero import adam_scale_seen
from test_torch_learn import LR, _check_logs, assert_params_close, gradients_seen
from test_torch_model import perturbed_params

pytestmark = pytest.mark.unittest

TOL = 1e-5
VALUE_RTOL = VALUE_ATOL = 1e-4
KS, SIMS, DISCRETE_A = 3, 6, 6
# unroll steps of the learn tests: each step is hundreds of eager JAX ops
UNROLL = 3
# Adam with L2 decay adds WD * p to Adam's input: the sampled models'
# projector has the flax model's fixed widths (1024, 3.2M weights), whose SSL
# gradients are mostly below the 3e-5 at which tests/test_torch_learn.py holds
# an element to 1e-6 instead of 2 lr; at 1e-2 the decay term lifts them
# above it (at the default 1e-4 more than half would be held to 2 lr only)
WD = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def model_cfg(discrete: bool, **extra) -> dict:
    return dict(observation_shape=3, action_space_size=DISCRETE_A if discrete else 1,
                continuous_action_space=not discrete, latent_state_dim=16, support_scale=5,
                **extra)


def policy_cfg(discrete: bool, **override) -> dict:
    return dict(dict(model=model_cfg(discrete), num_simulations=SIMS, num_of_sampled_actions=KS,
                     batch_size=16, learning_rate=LR, optim_type="Adam", weight_decay=WD,
                     num_unroll_steps=UNROLL, piecewise_decay_lr_scheduler=False,
                     target_update_freq=2), **override)


def widths(discrete: bool) -> dict:
    cfg = model_cfg(discrete)
    del cfg["support_scale"]
    return dict(cfg, value_support_size=11, reward_support_size=11)


def _close(got, exp, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=tol, atol=tol)


def _values_close(got, exp):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=VALUE_RTOL,
                               atol=VALUE_ATOL)


def make_policies(jax_cls, port_cls, cfg, seed):
    """The JAX policy and the port's on the CPU, holding the same flax params
    perturbed from ``seed``, both with tie_break='first'."""
    jax_policy = jax_cls(jax_deep_merge(jax_cls.default_config(), cfg))
    jax_policy.search_cfg = dataclasses.replace(jax_policy.search_cfg, tie_break="first")
    params = perturbed_params(jax_policy.model, seed)
    port = port_cls(cfg, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    port.search_cfg = dataclasses.replace(port.search_cfg, tie_break="first")
    return jax_policy, jax.tree_util.tree_map(jnp.asarray, params), port


# ------------------------------------------------------------------ sampling
def test_default_config_is_the_jax_default():
    assert SampledMuZeroPolicy.default_config().to_dict() == \
        jax_smz.SampledMuZeroPolicy.default_config().to_dict()


@pytest.mark.parametrize("prior_space", ["pre_tanh", "squashed"])
def test_gaussian_tanh_sample_matches_jax(prior_space):
    rng = np.random.default_rng(0)
    B, K, D = 8, 5, 2
    mu = (rng.standard_normal((B, D)) * 1.5).astype(np.float32)
    sigma = rng.uniform(0.1, 2.0, (B, D)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    normals = np.asarray(jax.random.normal(key, (B, K, D), jnp.float32))
    exp_a, exp_logp = jax_smz.gaussian_tanh_sample(key, jnp.asarray(mu), jnp.asarray(sigma), K,
                                                   prior_space=prior_space)
    a, logp = smz.gaussian_tanh_sample(torch.from_numpy(mu), torch.from_numpy(sigma),
                                       torch.from_numpy(normals), prior_space=prior_space)
    np.testing.assert_allclose(a.numpy(), np.asarray(exp_a), rtol=TOL, atol=1e-7)
    exp_logp = np.asarray(exp_logp, np.float64)
    a64 = np.asarray(exp_a, np.float64)
    tanh_ulps = 5.0 if prior_space == "squashed" else 0.0
    sensitivity = np.sum(2 * np.abs(a64) / (1 - a64**2 + 1e-6)
                         * np.spacing(np.abs(np.asarray(exp_a))).astype(np.float64), axis=-1)
    bound = TOL * np.abs(exp_logp) + 1e-6 + tanh_ulps * sensitivity
    assert (np.abs(logp.numpy() - exp_logp) <= bound).all()
    if prior_space == "squashed":
        assert sensitivity.max() > 1e-3  # saturated draws are among the inputs


def test_gaussian_tanh_logp_matches_jax_near_the_bounds_too():
    rng = np.random.default_rng(1)
    B, K, D = 8, 6, 2
    actions = np.tanh(rng.standard_normal((B, K, D)) * 2).astype(np.float32)
    # at and next to +-1: the clip to 1 - 1e-6 and the last float32 steps below it
    edge = np.float32([1.0, 1 - 1e-7, 1 - 1e-6, 1 - 2e-6, 0.99999])
    actions[0, :5, 0] = edge
    actions[1, :5, 1] = -edge
    mu = rng.standard_normal((B, 1, D)).astype(np.float32)
    sigma = rng.uniform(0.1, 2.0, (B, 1, D)).astype(np.float32)
    exp = jax_smz.gaussian_tanh_logp(jnp.asarray(actions), jnp.asarray(mu), jnp.asarray(sigma))
    got = smz.gaussian_tanh_logp(*(torch.from_numpy(x) for x in (actions, mu, sigma)))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=TOL, atol=1e-6)
    assert np.isfinite(got.numpy()).all() and float(np.abs(np.asarray(exp)[:2]).max()) > 10


@pytest.mark.parametrize("masked", [False, True])
def test_sample_discrete_actions_matches_jax(masked):
    rng = np.random.default_rng(2)
    B, A, K = 8, 7, 4
    logits = rng.standard_normal((B, A)).astype(np.float32) * 2
    legal = rng.random((B, A)) < 0.8
    legal[:, :K] = True
    key = jax.random.PRNGKey(3)
    gumbel = np.asarray(jax.random.gumbel(key, (B, A), jnp.float32))
    mask = legal if masked else None
    exp_a, exp_logp = jax_smz.sample_discrete_actions(
        key, jnp.asarray(logits), K, legal_mask=None if mask is None else jnp.asarray(mask))
    a, logp = smz.sample_discrete_actions(torch.from_numpy(logits), K, torch.from_numpy(gumbel),
                                          legal_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(a.numpy(), np.asarray(exp_a))
    np.testing.assert_allclose(logp.numpy(), np.asarray(exp_logp), rtol=1e-6, atol=1e-6)
    assert (a.unsqueeze(-1) != a.unsqueeze(-2)).sum() == B * K * (K - 1)  # distinct
    if masked:
        assert torch.gather(torch.from_numpy(legal), 1, a).all()


@pytest.mark.parametrize("prior", ["uniform", "density"])
def test_sampled_search_prior_matches_jax(prior):
    logp = np.random.default_rng(4).standard_normal((5, 3)).astype(np.float32)
    cfg = dict(sampled_node_prior=prior)
    exp = jax_smz.sampled_search_prior(JaxConfig(cfg), jnp.asarray(logp))
    got = smz.sampled_search_prior(Config(cfg), torch.from_numpy(logp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


# --------------------------------------------------------------------- model
@pytest.fixture(scope="module", params=[False, True], ids=["continuous", "discrete"])
def models(request):
    discrete = request.param
    flax_model = JaxSMZModel(**widths(discrete))
    params = perturbed_params(flax_model, 0)
    port = SampledMuZeroModel(**widths(discrete))
    port.load_state_dict(flax_to_state_dict(params))
    return discrete, flax_model, params, port.eval()


def random_actions(rng, n, discrete):
    if discrete:
        return rng.integers(0, DISCRETE_A, n).astype(np.int32)
    return np.tanh(rng.standard_normal((n, 1))).astype(np.float32)


def _check_outputs(got, exp, discrete):
    for field in ("value_logits", "reward_logits", "latent_state"):
        _close(getattr(got, field), exp[field])
    policy_fields = ("policy_logits",) if discrete else ("mu", "sigma")
    for field in policy_fields:
        _close(getattr(got, field), exp[field])
    assert all(getattr(got, f) is None for f in ("policy_logits", "mu", "sigma")
               if f not in policy_fields)


def test_model_matches_flax_method_by_method(models):
    discrete, flax_model, params, port = models
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((6, 3)).astype(np.float32)
    with torch.no_grad():
        _close(port.representation(torch.from_numpy(obs)),
               flax_model.apply(params, jnp.asarray(obs), method=JaxSMZModel.representation))
        exp = flax_model.apply(params, jnp.asarray(obs), method=JaxSMZModel.initial_inference)
        got = port.initial_inference(torch.from_numpy(obs))
        _check_outputs(got, exp, discrete)
        assert not got.reward_logits.any() and got.reward_logits.shape == (6, 11)

        latent = np.maximum(rng.standard_normal((6, 16)), 0).astype(np.float32)
        action = random_actions(rng, 6, discrete)
        t_latent, t_action = torch.from_numpy(latent), torch.from_numpy(action)
        exp_pred = flax_model.apply(params, jnp.asarray(latent), method=JaxSMZModel.prediction)
        for g, e in zip(port.prediction(t_latent), exp_pred):
            _close(g, e)
        exp_dyn = flax_model.apply(params, jnp.asarray(latent), jnp.asarray(action),
                                   method=JaxSMZModel.dynamics)
        for g, e in zip(port.dynamics(t_latent, t_action), exp_dyn):
            _close(g, e)
        exp = flax_model.apply(params, jnp.asarray(latent), jnp.asarray(action),
                               method=JaxSMZModel.recurrent_inference)
        got = port.recurrent_inference(t_latent, t_action)
        _check_outputs(got, exp, discrete)
        assert float(np.abs(np.asarray(exp["reward_logits"])).max()) > 0.1  # a live head
        for with_grad in (True, False):
            e = flax_model.apply(params, jnp.asarray(latent), with_grad, method=JaxSMZModel.project)
            _close(port.project(t_latent, with_grad), e)


def test_import_is_exact_both_ways(models):
    _, _, params, port = models
    sd = flax_to_state_dict(params)
    assert set(sd) == set(port.state_dict())
    n_flax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == n_flax
    back = state_dict_to_flax(port.state_dict())
    exp = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(exp)
    for path, leaf in exp:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))
    # the sampled map: _dyn_torso is one torso, _common the prediction torso
    np.testing.assert_array_equal(sd["prediction_torso.dense.0.weight"].numpy(),
                                  np.asarray(params["params"]["_common"]["Dense_0"]["kernel"]).T)
    with pytest.raises(KeyError, match="_pred"):
        flax_to_state_dict({"params": dict(params["params"], _pred={"x": {"kernel": np.zeros(2)}})})


def test_default_init_is_flax_like():
    port = SampledMuZeroModel(**widths(False), generator=torch.Generator().manual_seed(0))
    for head in (port.value_head, port.reward_head, port.mu_head, port.sigma_head):
        assert not head.dense[-1].weight.any()
    out = port.initial_inference(torch.zeros((2, 3)))
    # mu = 0 and sigma = 0.1 + 1.9 sigmoid(0) = 1.05 at init
    assert not out.mu.any()
    torch.testing.assert_close(out.sigma, torch.full((2, 1), 1.05))


def test_conv_model_and_reanalyze_are_refused():
    # the conv model is ported (tests/test_torch_conv.py); an unknown type is not
    port = SampledMuZeroPolicy(dict(model=dict(model_type="conv", observation_shape=(6, 6, 3),
                                               num_channels=8, downsample=False)), device="cpu")
    assert port.model.model_type == "conv"
    with pytest.raises(ValueError, match="model_type"):
        SampledMuZeroPolicy(dict(model=dict(model_type="transformer")), device="cpu")
    with pytest.raises(NotImplementedError, match="reanalyze"):
        SampledMuZeroPolicy(policy_cfg(False, reanalyze_ratio=0.25), device="cpu")
    port = SampledMuZeroPolicy(policy_cfg(False), device="cpu")
    with pytest.raises(NotImplementedError, match="reanalyze"):
        port.forward_reanalyze(port.model, torch.zeros((2, 3)), torch.ones((2, 1), dtype=torch.bool))


# -------------------------------------------------------------------- search
def jax_draws(key, B, discrete, sims=SIMS):
    """The draws of JAX's _forward_collect from its key: the root's
    candidates, each simulation's candidates (its recurrent_fn's m_rng) and
    the root's Dirichlet noise over the K slots."""
    def draw(k):
        if discrete:
            return jax.random.gumbel(k, (B, DISCRETE_A), jnp.float32)
        return jax.random.normal(k, (B, KS, 1), jnp.float32)

    _, r_rng, s_rng, _ = jax.random.split(key, 4)
    rng, prep_rng = jax.random.split(s_rng)
    per_sim = []
    for _ in range(sims):
        rng, _, m_rng = jax.random.split(rng, 3)
        per_sim.append(np.asarray(draw(m_rng)))
    g = jax.random.gamma(prep_rng, 0.3, (B, KS), jnp.float32)
    noise = g / jnp.maximum(jnp.sum(g, axis=-1, keepdims=True), 1e-30)
    return (torch.from_numpy(np.asarray(draw(r_rng))), torch.from_numpy(np.stack(per_sim)),
            torch.from_numpy(np.asarray(noise)))


class _Keep:
    """Wraps a search function and keeps its last output."""

    def __init__(self, fn):
        self.fn, self.out = fn, None

    def __call__(self, *args, **kwargs):
        self.out = self.fn(*args, **kwargs)
        return self.out


def check_search(jax_policy, params, port, monkeypatch, jax_module, deterministic, discrete,
                 seed=5):
    """_forward_collect on both sides with JAX's draws: returns (got, exp)
    and the two searches' trees."""
    B = 4
    rng = np.random.default_rng(seed)
    obs = (rng.standard_normal((B, 3)) * np.array([1, 1, 3])).astype(np.float32)
    legal = np.ones((B, DISCRETE_A if discrete else 1), bool)
    key = jax.random.PRNGKey(seed)
    root_draws, sim_draws, noise = jax_draws(key, B, discrete)
    jax_keep = _Keep(jax_module.batch_puct_search)
    monkeypatch.setattr(jax_module, "batch_puct_search", jax_keep)
    port_keep = _Keep(smz.batch_puct_search)
    monkeypatch.setattr(smz, "batch_puct_search", port_keep)
    exp = jax_policy._forward_collect(params, key, jnp.asarray(obs), jnp.asarray(legal),
                                      jnp.full((B,), -1, jnp.int32), 1.0, 0.0,
                                      deterministic=deterministic)
    got = port._forward_collect(torch.from_numpy(obs), torch.from_numpy(legal),
                                torch.full((B,), -1, dtype=torch.int32), 1.0, 0.0,
                                deterministic=deterministic, noise=None if deterministic else noise,
                                root_draws=root_draws, sim_draws=sim_draws)
    tree, jtree = port_keep.out.tree, jax_keep.out.tree
    np.testing.assert_array_equal(got["visit_counts"].numpy(), np.asarray(exp["visit_counts"]))
    np.testing.assert_array_equal(tree.children.numpy(), np.asarray(jtree.children))
    np.testing.assert_array_equal(tree.visit_count.numpy(), np.asarray(jtree.visit_count))
    assert got["visit_counts"].sum(dim=1).tolist() == [SIMS] * B
    if discrete:
        np.testing.assert_array_equal(got["root_sampled_actions"].numpy(),
                                      np.asarray(exp["root_sampled_actions"]))
        np.testing.assert_array_equal(tree.embedding["sampled_actions"].numpy(),
                                      np.asarray(jtree.embedding["sampled_actions"]))
    else:
        _close(got["root_sampled_actions"], exp["root_sampled_actions"])
        _close(tree.embedding["sampled_actions"], jtree.embedding["sampled_actions"])
    _close(tree.prior, jtree.prior)
    for k in ("searched_value", "predicted_value"):
        _values_close(got[k], exp[k])
    if deterministic:
        np.testing.assert_array_equal(got["chosen_slot"].numpy(), np.asarray(exp["chosen_slot"]))
        # the chosen slot's candidate: a tanh, which XLA rounds up to 4 ulp off
        if discrete:
            np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
        else:
            _close(got["action"], exp["action"])
    return got, exp, tree, jtree


SEARCH_CASES = [(False, "uniform", False), (False, "density", True), (True, "density", False),
                (True, "uniform", True)]


@pytest.mark.parametrize("discrete,prior,deterministic", SEARCH_CASES,
                         ids=["continuous-uniform-collect", "continuous-density-eval",
                              "discrete-density-collect", "discrete-uniform-eval"])
def test_forward_collect_searches_as_jax(monkeypatch, discrete, prior, deterministic):
    cfg = policy_cfg(discrete, sampled_node_prior=prior)
    jax_policy, params, port = make_policies(jax_smz.SampledMuZeroPolicy, SampledMuZeroPolicy,
                                             cfg, seed=3)
    got, exp, _, _ = check_search(jax_policy, params, port, monkeypatch, jax_smz, deterministic,
                                  discrete)
    if not discrete:
        for k in ("visit_mean_action", "collect_mu", "collect_sigma"):
            _close(got[k], exp[k])
    else:
        assert "collect_mu" not in got and "collect_mu" not in exp


def test_forward_collect_draws_from_the_policys_generator():
    port = SampledMuZeroPolicy(policy_cfg(False), device="cpu")
    obs, legal = torch.zeros((4, 3)), torch.ones((4, 1), dtype=torch.bool)
    a = port.forward_collect(obs, legal)
    b = port.forward_collect(obs, legal)
    assert a["root_sampled_actions"].shape == (4, KS, 1) and a["action"].shape == (4, 1)
    assert not torch.equal(a["root_sampled_actions"], b["root_sampled_actions"])
    assert (a["action"].abs() <= 1).all()
    port.generator.manual_seed(0)
    c = port.forward_eval(obs, legal)
    port.generator.manual_seed(0)
    torch.testing.assert_close(port.forward_eval(obs, legal)["action"], c["action"])


# --------------------------------------------------------------------- learn
def sampled_batch(seed, discrete, B=16, K=UNROLL):
    """A numpy-seeded sampled batch: candidates at and near +-1 among them,
    trailing unroll steps masked, value targets beyond the support."""
    rng = np.random.default_rng(seed)
    steps_left = rng.integers(0, K + 1, B)
    mask = (np.arange(K)[None] < steps_left[:, None]).astype(np.float32)
    policy = rng.dirichlet(np.ones(KS), (B, K + 1)).astype(np.float32)
    policy[:, 1:] *= np.concatenate([mask, np.ones((B, 1), np.float32)], 1)[:, :K, None]
    if discrete:
        actions = rng.integers(0, DISCRETE_A, (B, K)).astype(np.int64)
        sampled = np.stack([[rng.permutation(DISCRETE_A)[:KS] for _ in range(K + 1)]
                            for _ in range(B)]).astype(np.float32)
    else:
        actions = rng.uniform(-1, 1, (B, K, 1)).astype(np.float32)
        sampled = np.tanh(rng.standard_normal((B, K + 1, KS, 1)) * 2).astype(np.float32)
        sampled[0, 0, :, 0] = [1.0, -1.0, 1 - 1e-6]
    return dict(
        obs=rng.standard_normal((B, K + 1, 3)).astype(np.float32),
        actions=actions,
        mask=mask,
        target_reward=rng.uniform(-8, 0, (B, K)).astype(np.float32),
        target_value=rng.uniform(-60, 10, (B, K + 1)).astype(np.float32),
        target_policy=policy,
        weights=rng.uniform(0.2, 1.0, B).astype(np.float32),
        sampled_actions=sampled,
    )


def as_jax_batch(b):
    base = {k: jnp.asarray(v.astype(np.int32) if k == "actions" and v.dtype.kind == "i" else v)
            for k, v in b.items() if k != "sampled_actions"}
    return jax_smz.SampledTrainBatch(base=JaxTrainBatch(**base),
                                     sampled_actions=jnp.asarray(b["sampled_actions"]))


def as_port_batch(b):
    base = {k: torch.from_numpy(v) for k, v in b.items() if k != "sampled_actions"}
    return SampledTrainBatch(base=TrainBatch(**base),
                             sampled_actions=torch.from_numpy(b["sampled_actions"]))


LEARN_CASES = [(False, False), (False, True), (True, False), (True, True)]
LEARN_IDS = ["continuous", "continuous-normalized", "discrete", "discrete-normalized"]


@pytest.fixture(scope="module")
def jax_learners():
    """One JAX policy per case."""
    return {case: jax_smz.SampledMuZeroPolicy(jax_deep_merge(
        jax_smz.SampledMuZeroPolicy.default_config(),
        policy_cfg(case[0], normalize_prob_of_sampled_actions=case[1])))
        for case in LEARN_CASES}


def learn_states(jax_policy, port, seed):
    params = jax.tree_util.tree_map(jnp.asarray, perturbed_params(jax_policy.model, seed))
    jax_state = JaxTrainState(
        params=params,
        target_params=jax.tree_util.tree_map(jnp.copy, params),
        opt_state=jax_policy.optimizer.init(params),
        train_iter=jnp.zeros((), jnp.int32),
    )
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jax_state, port.init_train_state()


@pytest.mark.parametrize("case", LEARN_CASES, ids=LEARN_IDS)
def test_learn_step_matches_jax(jax_learners, case):
    discrete, normalize = case
    jax_policy = jax_learners[case]
    port = SampledMuZeroPolicy(policy_cfg(discrete, normalize_prob_of_sampled_actions=normalize),
                               device="cpu")
    jax_state, state = learn_states(jax_policy, port, 0)
    b = sampled_batch(0, discrete)
    seen = gradients_seen(jax_policy, jax_state.params, as_jax_batch(b))
    jax_new, jax_logs, jax_priority = jax_policy._forward_learn(jax_state, as_jax_batch(b))
    new, logs, priority = port.forward_learn(state, as_port_batch(b))
    assert "reward_loss" in logs and float(logs["consistency_loss"]) != 0.0
    _check_logs(logs, jax_logs)
    np.testing.assert_allclose(priority.numpy(), np.asarray(jax_priority), rtol=1e-5, atol=1e-5)
    assert new.train_iter == 1
    assert_params_close(port.model, jax_new.params, seen)


def test_three_learn_steps_with_a_target_copy(jax_learners):
    jax_policy = jax_learners[(False, True)]
    port = SampledMuZeroPolicy(policy_cfg(False, normalize_prob_of_sampled_actions=True),
                               device="cpu")
    jax_state, state = learn_states(jax_policy, port, 1)
    seen = None
    for step in range(3):
        b = sampled_batch(10 + step, False)
        seen, held = adam_scale_seen(jax_policy, jax_state.params, as_jax_batch(b), seen)
        jax_state, jax_logs, _ = jax_policy._forward_learn(jax_state, as_jax_batch(b))
        state, logs, _ = port.forward_learn(state, as_port_batch(b))
        _values_close(logs.pop("predicted_value"), jax_logs.pop("predicted_value"))
        _check_logs(logs, jax_logs)
        assert state.train_iter == int(jax_state.train_iter) == step + 1
        assert_params_close(port.model, jax_state.params, held)
        assert_params_close(state.target_model, jax_state.target_params, held)


# ------------------------------------------------------- collector and buffer
def test_collector_stores_float_actions_and_root_candidates():
    port = SampledMuZeroPolicy(policy_cfg(False), device="cpu")
    collector = RolloutCollector(PendulumEnv(max_episode_steps=5), port, num_envs=2,
                                 rollout_length=6, device="cpu")
    episodes, priorities, stats = collector.collect(num_episodes=2)
    assert len(episodes) == 2 and all(len(p) == 5 for p in priorities)
    for ep in episodes:
        assert ep.actions.dtype == np.float32 and ep.actions.shape == (5, 1)
        assert ep.root_sampled_actions.shape == (5, KS, 1)
        assert ep.child_visits.shape == (5, KS) and ep.legal_mask.shape == (5, 1)
        assert ep.truncated and not ep.chance.any()
        # the action taken is one of the step's candidates
        assert (np.abs(ep.root_sampled_actions - ep.actions[:, None]) == 0).any(axis=(1, 2)).all()
    for k in ("visit_mean_action", "collect_mu", "collect_sigma"):
        assert math.isfinite(stats[k])


def sampled_episodes(seed, discrete, n=6):
    rng = np.random.default_rng(seed)
    episodes, priorities = [], []
    for i in range(n):
        T = int(rng.integers(3, 30))
        visits = rng.integers(0, 6, (T, KS)).astype(np.float32)
        visits[:, 0] += 1
        if discrete:
            actions = rng.integers(0, DISCRETE_A, T).astype(np.int64)
            rsa = np.stack([rng.permutation(DISCRETE_A)[:KS] for _ in range(T)]).astype(np.float32)
        else:
            actions = rng.uniform(-1, 1, (T, 1)).astype(np.float32)
            rsa = rng.uniform(-1, 1, (T, KS, 1)).astype(np.float32)
        episodes.append(dict(
            obs=rng.standard_normal((T, 3)).astype(np.float32), actions=actions,
            rewards=rng.uniform(-8, 0, T).astype(np.float32),
            child_visits=visits / visits.sum(-1, keepdims=True),
            root_values=rng.standard_normal(T).astype(np.float32),
            legal_mask=np.ones((T, DISCRETE_A if discrete else 1), bool),
            to_play=np.full(T, -1, np.int64), truncated=bool(i % 2), chance=np.zeros(T, np.int64),
            root_sampled_actions=rsa))
        priorities.append(rng.uniform(0.1, 3.0, T) if i % 2 else None)
    return episodes, priorities


@pytest.mark.parametrize("discrete", [False, True], ids=["continuous", "discrete"])
def test_buffer_sampled_batch_matches_jax(discrete):
    # the default 5 unroll steps: more samples reach past an episode's end
    cfg = policy_cfg(discrete, seed=3, num_unroll_steps=5)
    jax_policy, params, port = make_policies(jax_smz.SampledMuZeroPolicy, SampledMuZeroPolicy,
                                             cfg, seed=4)
    jax_buf = JaxGameBuffer(jax_policy.cfg, jax_policy)
    buf = GameBuffer(port.cfg, port)
    episodes, priorities = sampled_episodes(7, discrete)
    jax_buf.push_episodes([JaxEpisodeRecord(**e) for e in episodes], priorities)
    buf.push_episodes([EpisodeRecord(**e) for e in episodes], priorities)
    for _ in range(2):
        exp, exp_idx = jax_buf.sample(16, params)
        got, idx = buf.sample(16, port.model)
        np.testing.assert_array_equal(idx, exp_idx)
        assert isinstance(got, SampledTrainBatch)
        assert got.base.actions.dtype == (torch.int64 if discrete else torch.float32)
        for f in ("obs", "actions", "mask", "target_reward", "target_policy", "weights"):
            np.testing.assert_allclose(getattr(got.base, f).numpy(),
                                       np.asarray(getattr(exp.base, f)), rtol=1e-6, atol=1e-6,
                                       err_msg=f)
        np.testing.assert_allclose(got.base.target_value.numpy(), np.asarray(exp.base.target_value),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.sampled_actions.numpy(), np.asarray(exp.sampled_actions))
        assert (got.base.mask == 0).any()  # episodes end inside unrolls: padded actions


# --------------------------------------------------------------------- train
def tiny_cfg(exp_dir, policy_type="sampled_muzero", **policy):
    return Config(dict(
        exp_name=str(exp_dir),
        env=dict(env_id="Pendulum-v1", stop_value=1, collector_env_num=2, evaluator_env_num=2,
                 n_evaluator_episode=2, max_episode_steps=20),
        policy=dict(dict(type=policy_type, model=model_cfg(False), num_simulations=4,
                         num_of_sampled_actions=KS, batch_size=16, update_per_collect=2,
                         n_episode=2, eval_freq=1000), **policy),
    ))


def test_train_muzero_trains_sampled_muzero_on_pendulum_on_the_cpu(tmp_path):
    exp = tmp_path / "exp"
    policy, state, stats = train_muzero(tiny_cfg(exp), seed=0, max_train_iter=4, device="cpu")
    assert isinstance(policy, SampledMuZeroPolicy) and isinstance(state.model, SampledMuZeroModel)
    assert stats["train_iter"] == 4 and stats["env_steps"] == 256
    with open(exp / "log" / "train.jsonl") as f:
        records = [json.loads(line) for line in f]
    learner = [r for r in records if "learner/total_loss" in r]
    assert len(learner) == 2
    for r in learner:
        assert all(math.isfinite(r[f"learner/{k}"]) for k in
                   ("total_loss", "policy_loss", "reward_loss", "consistency_loss"))
    assert any("collector/collect_sigma" in r for r in records)
    assert os.path.exists(exp / "ckpt" / "ckpt_final.pt")


def test_pendulum_config_raises_with_no_cuda(tmp_path, monkeypatch):
    from lightzero_tpu_torch.configs.pendulum_sampled_muzero import main_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = copy.deepcopy(main_config)
    cfg.exp_name = str(tmp_path / "exp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_muzero(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SampledMuZeroPolicy(cfg.policy)
    assert not os.path.exists(tmp_path / "exp")


def test_pendulum_config_is_the_zoo_config():
    from lightzero_tpu_torch.configs.pendulum_sampled_muzero import main_config
    from zoo.classic_control.pendulum.config.pendulum_sampled_muzero_config import (
        main_config as zoo_config,
    )

    assert main_config.to_dict() == JaxConfig(zoo_config).to_dict()
