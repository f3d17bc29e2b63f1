"""Port vs JAX: Stochastic MuZero, MLP branch (lightzero_tpu_torch/models/
stochastic_muzero.py, policy/stochastic_muzero.py and the generic descent of
search/puct.py against lightzero_tpu/models/stochastic_muzero.py,
lightzero_tpu/policy/stochastic_muzero.py and lightzero_tpu/search/puct.py),
at small widths: observations of 256 (4 x 4 x 16), 4 actions, 6 chance
outcomes (a tree 6 wide), latent 16, supports of 11 atoms (scale 5). The
flax weights are perturbed from a numpy seed (the flax init zeroes the
heads' last layers) and carried across with utils/params_import.py.

- The model method by method, chance_encode's straight-through gradient
  included: 1e-5 absolute. The import is exact both ways.
- The generic descent on the same packed trees (stochastic trees grown by
  the JAX search, both tie-breaks), with the JAX descent's own uniform and
  Gumbel tables rebuilt from its key: leaves, parents, actions, depths,
  to-play and the path tables exactly equal.
- batch_puct_search with stochastic=True and the policies' recurrent fns,
  the same Dirichlet noise, tie_break='first', and the Gumbel tables rebuilt
  from JAX's key splits (puct.py:781,789, then :379-385): visit counts,
  children, is_chance and visit counts of every node equal; root values
  within 1e-4 relative, with a floor of 1e-4 absolute. The floor is the
  inverse value transform's cancellation (ROADMAP queue 3): an afterstate's
  reward is h^-1 of the expectation of zero logits, which JAX sums to
  -2.6e-5 and the port to +2.6e-5 at 11 atoms, and each afterstate edge of
  a path adds that difference to the backed-up values.
- forward_eval: actions and visit counts equal, values as the root values.
- The learn step against the jitted JAX learn step, with the true chance
  labels and with the encoder's own codes: the logged terms 1e-5 relative,
  priorities 1e-5; the params after three steps (target copy at step 2)
  under the per-step Adam-scale criterion of tests/test_torch_efficientzero.py.
  The JAX policy's encoder-code branch passes ``jax.nn.one_hot``'s dtype by
  position, which this JAX takes by keyword only (a TypeError, shown here);
  that branch runs against a ``one_hot`` that takes it by position too.
- Refusals: a conv model (the policy flattens observations) and reanalyze,
  which the JAX policy cannot run (its forward_reanalyze raises a
  broadcasting ValueError, shown here); without a GPU and a device the policy and train_muzero raise.
- The buffer's native and Python paths give the chance codes as JAX's;
  train_muzero on a tiny 2048 config on the CPU.
"""
import copy
import dataclasses
import functools
import json
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
from lightzero_tpu.models.stochastic_muzero import StochasticMuZeroModel as JaxSMZModel
from lightzero_tpu.ops import inverse_scalar_transform as jax_inverse
from lightzero_tpu.policy.muzero import TrainBatch as JaxTrainBatch
from lightzero_tpu.policy.muzero import TrainState as JaxTrainState
from lightzero_tpu.policy.stochastic_muzero import StochasticMuZeroPolicy as JaxSMZPolicy
from lightzero_tpu.search import batch_puct_search as jax_search
from lightzero_tpu.search import puct as jax_puct
from lightzero_tpu.search.types import RootOutput as JaxRootOutput
from lightzero_tpu.search.types import SearchConfig as JaxSearchConfig
from lightzero_tpu_torch.buffers import EpisodeRecord, GameBuffer
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import train_muzero
from lightzero_tpu_torch.models import StochasticMuZeroModel
from lightzero_tpu_torch.ops import inverse_scalar_transform
from lightzero_tpu_torch.policy import StochasticMuZeroPolicy
from lightzero_tpu_torch.policy.muzero import TrainBatch
from lightzero_tpu_torch.search import RootOutput, SearchConfig, batch_puct_search
from lightzero_tpu_torch.search import puct
from lightzero_tpu_torch.search.tree import Tree
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict, state_dict_to_flax
from test_torch_efficientzero import adam_scale_seen
from test_torch_learn import LR, _check_logs, assert_params_close, random_batch
from test_torch_model import perturbed_params

pytestmark = pytest.mark.unittest

TOL = 1e-5
VALUE_RTOL = VALUE_ATOL = 1e-4
OBS, A, C, W = 256, 4, 6, 6
WIDTHS = dict(observation_shape=OBS, action_space_size=A, chance_space_size=C, latent_state_dim=16,
              value_support_size=11, reward_support_size=11)
MODEL = dict(observation_shape=OBS, action_space_size=A, chance_space_size=C, latent_state_dim=16,
             support_scale=5)
POLICY = dict(model=MODEL, num_simulations=6, batch_size=16, learning_rate=LR, optim_type="Adam",
              piecewise_decay_lr_scheduler=False, target_update_freq=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, exp, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=tol, atol=tol)


def _values_close(got, exp):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=VALUE_RTOL,
                               atol=VALUE_ATOL)


def boards_obs(rng, n):
    """One-hot planes (n, 4, 4, 16) of random 2048 boards."""
    boards = rng.integers(0, 8, (n, 4, 4))
    boards[rng.random((n, 4, 4)) < 0.4] = 0
    return np.eye(16, dtype=np.float32)[boards]


@pytest.fixture(scope="module")
def models():
    flax_model = JaxSMZModel(**WIDTHS)
    params = perturbed_params(flax_model, 0)
    port = StochasticMuZeroModel(**WIDTHS)
    port.load_state_dict(flax_to_state_dict(params))
    return flax_model, params, port.eval()


def test_default_config_is_the_jax_default():
    assert StochasticMuZeroPolicy.default_config().to_dict() == JaxSMZPolicy.default_config().to_dict()


def test_model_matches_flax(models):
    flax_model, params, port = models
    rng = np.random.default_rng(1)
    obs = boards_obs(rng, 6).reshape(6, -1)
    exp = flax_model.apply(params, jnp.asarray(obs), method=JaxSMZModel.initial_inference)
    with torch.no_grad():
        got = port.initial_inference(torch.from_numpy(obs))
    for field in ("value_logits", "reward_logits", "policy_logits", "latent_state"):
        _close(getattr(got, field), getattr(exp, field))
    assert not got.reward_logits.any() and got.reward_logits.shape == (6, 11)

    latent = np.maximum(rng.standard_normal((6, 16)), 0).astype(np.float32)
    for afterstate, width in ((False, A), (True, C)):
        action = rng.integers(0, width, 6).astype(np.int32)
        exp = flax_model.apply(params, jnp.asarray(latent), jnp.asarray(action), afterstate,
                               method=JaxSMZModel.recurrent_inference)
        with torch.no_grad():
            got = port.recurrent_inference(torch.from_numpy(latent), torch.from_numpy(action),
                                           afterstate)
        # a decision step gives the chance logits (C wide) and a zero reward
        assert got.policy_logits.shape == (6, C if not afterstate else A)
        assert bool(got.reward_logits.any()) == afterstate
        for field in ("value_logits", "reward_logits", "policy_logits", "latent_state"):
            _close(getattr(got, field), getattr(exp, field))


def test_chance_encoder_and_its_straight_through_gradient_match_flax(models):
    flax_model, params, port = models
    rng = np.random.default_rng(2)
    pair = np.concatenate([boards_obs(rng, 5).reshape(5, -1), boards_obs(rng, 5).reshape(5, -1)], 1)
    weights = rng.standard_normal((5, C)).astype(np.float32)
    logits, onehot = flax_model.apply(params, jnp.asarray(pair), method=JaxSMZModel.chance_encode)
    # the one-hot's gradient is the softmax's (straight through the argmax)
    exp_grad = jax.grad(lambda x: jnp.sum(flax_model.apply(
        params, x, method=JaxSMZModel.chance_encode)[1] * weights))(jnp.asarray(pair))
    x = torch.from_numpy(pair).requires_grad_(True)
    got_logits, got_onehot = port.chance_encode(x)
    (got_onehot * torch.from_numpy(weights)).sum().backward()
    _close(got_logits, logits)
    np.testing.assert_array_equal(got_onehot.detach().numpy(), np.asarray(onehot))
    assert (got_onehot.detach().sum(-1) == 1).all()
    _close(x.grad, exp_grad)


def test_import_is_exact_both_ways_and_the_maps_do_not_collide(models):
    _, params, port = models
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
    # Stochastic MuZero's _dyn is one torso, MuZero's holds two
    assert set(back["params"]["_dyn"]) == {"Dense_0", "Dense_1", "LayerNorm_0", "LayerNorm_1"}
    np.testing.assert_array_equal(sd["dynamics_network.dense.0.weight"].numpy(),
                                  np.asarray(params["params"]["_dyn"]["Dense_0"]["kernel"]).T)
    bad = {"params": dict(params["params"], _proj={"proj_0": {"kernel": np.zeros((2, 2))}})}
    with pytest.raises(KeyError, match="_proj"):
        flax_to_state_dict(bad)
    with pytest.raises(KeyError, match="dynamics_network.torso"):
        state_dict_to_flax(dict(port.state_dict(), **{"dynamics_network.torso.dense.0.weight":
                                                      torch.zeros(2, 2)}))


def test_default_init_is_flax_like():
    port = StochasticMuZeroModel(**WIDTHS, generator=torch.Generator().manual_seed(0))
    for head in (port.reward_head, port.prediction_network.value_head,
                 port.prediction_network.policy_head, port.afterstate_prediction_network.value_head,
                 port.afterstate_prediction_network.policy_head):
        assert not head.dense[-1].weight.any()
    assert port.chance_encoder.dense[-1].weight.any()  # not zero-initialised in flax either
    assert port.afterstate_dynamics_network.norm[-1].eps == 1e-6


def test_conv_model_and_reanalyze_are_refused():
    # the conv model is ported (tests/test_torch_conv.py), but this policy
    # flattens observations, as the JAX policy does, which fails on it
    # (ROADMAP queue 3; tests/test_torch_train.py shows the JAX failure)
    with pytest.raises(ValueError, match="flattens observations"):
        StochasticMuZeroPolicy(dict(model=dict(MODEL, model_type="conv")), device="cpu")
    with pytest.raises(NotImplementedError, match="reanalyze"):
        StochasticMuZeroPolicy(dict(POLICY, reanalyze_ratio=0.25), device="cpu")
    port = StochasticMuZeroPolicy(POLICY, device="cpu")
    with pytest.raises(NotImplementedError, match="reanalyze"):
        port.forward_reanalyze(port.model, torch.zeros(2, OBS), torch.ones(2, A, dtype=torch.bool))


def test_the_jax_policys_reanalyze_fails_on_its_own_tree_width(jax_policies):
    """Why the port refuses reanalyze: the JAX policy's reanalyze search
    builds an A-wide tree for recurrent outputs tree_width wide."""
    jax_policy = jax_policies[True]
    params = jax.tree_util.tree_map(jnp.asarray, perturbed_params(jax_policy.model, 1))
    obs = jnp.asarray(boards_obs(np.random.default_rng(3), 2).reshape(2, -1))
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        jax_policy.forward_reanalyze(params, jax.random.PRNGKey(0), obs, jnp.ones((2, A), bool))


# ------------------------------------------------------------------ search


def _roots(jax_policy, port, params, obs):
    """The same roots on both sides: the initial inference, the prior padded
    to the tree width at -1e9 and the root embedding."""
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    out0 = jax_policy._initial(jparams, jnp.asarray(obs))
    jroot = JaxRootOutput(prior_logits=jax_policy._pad_width(out0.policy_logits, -1e9),
                          value=jax_inverse(out0.value_logits, jax_policy.value_support),
                          embedding=jax_policy._root_embedding(out0))
    with torch.no_grad():
        o0 = port.model.initial_inference(port._flat(torch.from_numpy(obs)))
        root = RootOutput(prior_logits=port._pad_width(o0.policy_logits, -1e9),
                          value=inverse_scalar_transform(o0.value_logits, port.value_support),
                          embedding=port._root_embedding(o0))
    return jparams, jroot, root


def jax_chance_tables(search_rng, sims, shape, tie_break="first"):
    """The Gumbel tables the JAX search draws, one per simulation: the
    search's key splits once for the root noise (puct.py:781), then three
    ways per simulation (:789), and the descent's key once more for the
    tie-break uniforms under 'noise' and once for the Gumbel table
    (:366-385)."""
    rng, _ = jax.random.split(search_rng)
    tables = []
    for _ in range(sims):
        rng, t_rng, _ = jax.random.split(rng, 3)
        if tie_break != "first":
            t_rng, _ = jax.random.split(t_rng)
        _, g_rng = jax.random.split(t_rng)
        tables.append(np.asarray(jax.random.gumbel(g_rng, shape, jnp.float32)))
    return torch.from_numpy(np.stack(tables))


def _search_pair(jax_policies, seed, sims, B=6):
    jax_policy = jax_policies[True]
    port = StochasticMuZeroPolicy(POLICY, device="cpu")
    params = perturbed_params(jax_policy.model, 10 + seed)
    port.model.load_state_dict(flax_to_state_dict(params))
    rng = np.random.default_rng(seed)
    obs = boards_obs(rng, B).reshape(B, -1)
    legal = np.zeros((B, W), bool)
    legal[:, :A] = rng.random((B, A)) < 0.8
    legal[:, 0] = True
    noise = np.zeros((B, W), np.float32)
    noise[:, :A] = rng.dirichlet(np.full(A, 0.3), B)
    noise = np.where(legal, noise, 0.0).astype(np.float32)
    jparams, jroot, root = _roots(jax_policy, port, params, obs)
    key = jax.random.PRNGKey(seed)
    jcfg = JaxSearchConfig(num_simulations=sims, tie_break="first", stochastic=True)
    exp = jax_search(jparams, key, jroot, jax_policy._recurrent_fn, jcfg, jnp.asarray(legal),
                     to_play=jnp.full((B,), -1, jnp.int32), noise=jnp.asarray(noise))
    got = batch_puct_search(
        root, functools.partial(port._recurrent_fn, port.model),
        SearchConfig(num_simulations=sims, tie_break="first", stochastic=True),
        torch.from_numpy(legal), noise=torch.from_numpy(noise), device="cpu",
        chance_noise=jax_chance_tables(key, sims, (sims + 2, B, W)))
    return exp, got


@pytest.mark.parametrize("seed,sims", [(0, 8), (1, 20)])
def test_search_matches_jax(jax_policies, seed, sims):
    exp, got = _search_pair(jax_policies, seed, sims)
    np.testing.assert_array_equal(got.visit_counts.numpy(), np.asarray(exp.visit_counts))
    for name in ("children", "is_chance", "visit_count", "legal"):
        np.testing.assert_array_equal(getattr(got.tree, name).numpy(),
                                      np.asarray(getattr(exp.tree, name)), err_msg=name)
    _values_close(got.root_value, exp.root_value)
    np.testing.assert_allclose(got.tree.value_sum.numpy(), np.asarray(exp.tree.value_sum),
                               rtol=VALUE_RTOL, atol=VALUE_ATOL * 10)
    # the tree alternates: every child of a chance node is a decision node
    ch, is_chance = got.tree.children.numpy(), got.tree.is_chance.numpy()
    b, n, _ = np.nonzero(ch >= 0)
    assert (is_chance[b, ch[ch >= 0]] == ~is_chance[b, n]).all()
    assert is_chance.any() and (ch[is_chance] >= 0).any()  # chance nodes were expanded below


def _as_port_tree(t) -> Tree:
    return Tree(**{name: torch.from_numpy(np.array(getattr(t, name)))
                   for name in Tree._fields if name != "embedding"}, embedding=None)


@pytest.mark.parametrize("tie_break", ["first", "noise"])
def test_descent_matches_jax_on_the_same_trees(jax_policies, tie_break):
    """The JAX descent (XLA, one-hot gathers) and the port's generic descent
    from the same packed tables of trees the JAX search grew."""
    exp_search, _ = _search_pair(jax_policies, 2, 16, B=8)
    jtree = exp_search.tree
    cfg_kw = dict(num_simulations=16, tie_break=tie_break, stochastic=True)
    jcfg, cfg = JaxSearchConfig(**cfg_kw), SearchConfig(**cfg_kw)
    tree = _as_port_tree(jtree)
    to_play = np.full(8, -1, np.int32)
    np.testing.assert_array_equal(puct._pack_traverse_tables(tree).numpy(),
                                  np.asarray(jax_puct._pack_traverse_tables(jtree)))
    for seed in range(3):
        rng = jax.random.PRNGKey(100 + seed)
        exp, exp_parent = jax_puct._traverse(jcfg, jtree, rng, jnp.asarray(to_play))
        shape = (tree.num_nodes + 1, 8, W)
        noise_u = None
        if tie_break != "first":
            rng, u_rng = jax.random.split(rng)
            noise_u = torch.from_numpy(np.array(jax.random.uniform(u_rng, shape, jnp.float32)))
        _, g_rng = jax.random.split(rng)
        noise_g = torch.from_numpy(np.array(jax.random.gumbel(g_rng, shape, jnp.float32)))
        got = puct._generic_traverse(cfg, tree, torch.from_numpy(to_play),
                                     puct._pack_traverse_tables(tree), noise_u, noise_g)
        for name, g, e in (("node", got.node, exp.node), ("depth", got.depth, exp.depth),
                           ("parent", got.parent, exp_parent),
                           ("last_action", got.last_action, exp.last_action),
                           ("leaf_is_terminal_node", got.leaf_is_terminal_node,
                            exp.leaf_is_terminal_node),
                           ("virtual_to_play", got.virtual_to_play, exp.virtual_to_play),
                           ("path", got.path, exp.path), ("path_reward", got.path_reward,
                                                          exp.path_reward),
                           ("path_vsum", got.path_vsum, exp.path_vsum),
                           ("path_visit", got.path_visit, exp.path_visit)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=f"{name} {seed}")
        # descents pass through chance nodes
        on_path = tree.is_chance.numpy()[np.arange(8)[:, None], got.path.numpy()]
        assert (on_path & (np.arange(shape[0])[None] <= got.depth.numpy()[:, None])).any()


# ------------------------------------------------------------------ policy


@pytest.fixture(scope="module")
def jax_policies():
    """One JAX policy per chance-label mode (one jit of its learn step each)."""
    return {true: JaxSMZPolicy(jax_deep_merge(
        JaxSMZPolicy.default_config(), dict(POLICY, use_ture_chance_label_in_chance_encoder=true)))
        for true in (True, False)}


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_eval_matches_jax(jax_policies, seed):
    jax_policy = copy.copy(jax_policies[True])
    jax_policy.search_cfg = dataclasses.replace(jax_policy.search_cfg, tie_break="first")
    jax_policy._jit_collect = jax.jit(jax_policy._forward_collect,
                                      static_argnames=("deterministic",))
    port = StochasticMuZeroPolicy(POLICY, device="cpu")
    port.search_cfg = dataclasses.replace(port.search_cfg, tie_break="first")
    params = perturbed_params(jax_policy.model, 20 + seed)
    port.model.load_state_dict(flax_to_state_dict(params))
    rng = np.random.default_rng(seed)
    B = 5
    obs = boards_obs(rng, B)
    legal = rng.random((B, A)) < 0.7
    legal[:, 1] = True
    key = jax.random.PRNGKey(30 + seed)
    exp = jax_policy.forward_eval(jax.tree_util.tree_map(jnp.asarray, params), key,
                                  jnp.asarray(obs), jnp.asarray(legal))
    # the policy splits its key five ways; the second is the search's
    s_rng = jax.random.split(key, 5)[1]
    sims = POLICY["num_simulations"]
    got = port._forward_collect(torch.from_numpy(obs), torch.from_numpy(legal),
                                torch.full((B,), -1, dtype=torch.int32), 1.0, 0.0,
                                deterministic=True,
                                chance_noise=jax_chance_tables(s_rng, sims, (sims + 2, B, W)))
    np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
    np.testing.assert_array_equal(got["visit_counts"].numpy(), np.asarray(exp["visit_counts"]))
    assert got["visit_counts"].shape == (B, A) and legal[np.arange(B), got["action"]].all()
    for name in ("searched_value", "predicted_value"):
        _values_close(got[name], exp[name])
    _close(got["policy_logits"], exp["policy_logits"])


def stochastic_batch(seed):
    b = random_batch(seed, A=A, obs_dim=OBS)
    b["chance"] = np.random.default_rng(seed + 1000).integers(0, C, b["actions"].shape)
    return b


def as_jax_batch(b):
    ints = ("actions", "chance")
    return JaxTrainBatch(**{k: jnp.asarray(v.astype(np.int32) if k in ints else v)
                            for k, v in b.items()})


def as_port_batch(b):
    return TrainBatch(**{k: torch.from_numpy(v) for k, v in b.items()})


def _states(jax_policy, port, seed):
    params = jax.tree_util.tree_map(jnp.asarray, perturbed_params(jax_policy.model, seed))
    jax_state = JaxTrainState(params=params, target_params=jax.tree_util.tree_map(jnp.copy, params),
                              opt_state=jax_policy.optimizer.init(params),
                              train_iter=jnp.zeros((), jnp.int32))
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jax_state, port.init_train_state()


def _one_hot_with_positional_dtype(one_hot):
    def wrapped(x, num_classes, dtype=jnp.float32, **kwargs):
        return one_hot(x, num_classes, dtype=dtype, **kwargs)

    return wrapped


def test_the_jax_policys_encoder_code_branch_passes_one_hots_dtype_by_position(jax_policies):
    jax_policy = jax_policies[False]
    params = jax.tree_util.tree_map(jnp.asarray, perturbed_params(jax_policy.model, 2))
    with pytest.raises(TypeError, match="one_hot"):
        jax_policy._loss_fn(params, as_jax_batch(stochastic_batch(1)))


@pytest.mark.parametrize("true_label", [True, False], ids=["true_label", "encoder_code"])
def test_three_learn_steps_match_jax(jax_policies, true_label, monkeypatch):
    jax_policy = jax_policies[true_label]
    if not true_label:
        monkeypatch.setattr(jax.nn, "one_hot", _one_hot_with_positional_dtype(jax.nn.one_hot))
    port = StochasticMuZeroPolicy(dict(POLICY, use_ture_chance_label_in_chance_encoder=true_label),
                                  device="cpu")
    jax_state, state = _states(jax_policy, port, 40 + int(true_label))
    seen = None
    for step in range(3):
        b = stochastic_batch(50 + step)
        seen, held = adam_scale_seen(jax_policy, jax_state.params, as_jax_batch(b), seen)
        jax_state, jax_logs, jax_priority = jax_policy.forward_learn(jax_state, as_jax_batch(b))
        state, logs, priority = port.forward_learn(state, as_port_batch(b))
        _check_logs(logs, jax_logs)
        np.testing.assert_allclose(priority.numpy(), np.asarray(jax_priority), rtol=1e-5,
                                   atol=1e-5)
        assert state.train_iter == int(jax_state.train_iter) == step + 1
        assert_params_close(port.model, jax_state.params, held)
        assert_params_close(state.target_model, jax_state.target_params, held)
        for key in ("afterstate_policy_loss", "afterstate_value_loss", "commitment_loss"):
            assert float(logs[key]) > 0, key
    assert "consistency_loss" not in logs


def test_true_labels_and_encoder_codes_give_other_losses(jax_policies):
    """The two branches differ where they should: the afterstate policy loss
    is against other targets, the rest of the unroll follows other codes."""
    b = stochastic_batch(60)
    logs = {}
    for true_label in (True, False):
        port = StochasticMuZeroPolicy(
            dict(POLICY, use_ture_chance_label_in_chance_encoder=true_label), device="cpu")
        port.model.load_state_dict(flax_to_state_dict(perturbed_params(jax_policies[True].model, 7)))
        logs[true_label] = port.forward_learn(port.init_train_state(), as_port_batch(b))[1]
    for key in ("afterstate_policy_loss", "commitment_loss", "value_loss"):
        assert float(logs[True][key]) != float(logs[False][key]), key


# ------------------------------------------------------------------ training


def random_2048_episodes(seed, n=6):
    rng = np.random.default_rng(seed)
    episodes, priorities = [], []
    for i in range(n):
        T = int(rng.integers(4, 30))
        visits = rng.integers(0, 6, (T, A)).astype(np.float32)
        visits[:, 0] += 1
        episodes.append(dict(
            obs=boards_obs(rng, T).reshape(T, -1),
            actions=rng.integers(0, A, T).astype(np.int64),
            rewards=rng.choice([0.0, 4.0, 8.0, 16.0], T).astype(np.float32),
            child_visits=visits / visits.sum(-1, keepdims=True),
            root_values=rng.standard_normal(T).astype(np.float32),
            legal_mask=np.ones((T, A), bool),
            to_play=np.full(T, -1, np.int64),
            truncated=bool(i % 2),
            chance=rng.integers(0, C, T).astype(np.int64),
        ))
        priorities.append(rng.uniform(0.1, 3.0, T) if i % 2 else None)
    return episodes, priorities


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_buffer_gives_the_chance_codes_as_jax(jax_policies, use_native):
    jax_policy = jax_policies[True]
    params = perturbed_params(jax_policy.model, 8)
    port = StochasticMuZeroPolicy(POLICY, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    cfg = dict(POLICY, seed=3, use_native_replay=use_native)
    jax_buf = JaxGameBuffer(jax_deep_merge(jax_policy.cfg, cfg), jax_policy)
    buf = GameBuffer(jax_deep_merge(port.cfg, cfg), port)
    episodes, priorities = random_2048_episodes(9)
    jax_buf.push_episodes([JaxEpisodeRecord(**e) for e in episodes], priorities)
    buf.push_episodes([EpisodeRecord(**e) for e in episodes], priorities)
    for _ in range(2):
        exp, exp_idx = jax_buf.sample(16, jax.tree_util.tree_map(jnp.asarray, params))
        got, idx = buf.sample(16, port.model)
        np.testing.assert_array_equal(idx, exp_idx)
        np.testing.assert_array_equal(got.chance.numpy(), np.asarray(exp.chance))
        np.testing.assert_allclose(got.target_value.numpy(), np.asarray(exp.target_value),
                                   rtol=1e-5, atol=1e-5)
        assert got.chance.dtype == torch.int64 and got.chance.any()


def tiny_cfg(exp_dir):
    from lightzero_tpu_torch.configs.game_2048_stochastic_muzero import main_config

    cfg = copy.deepcopy(main_config)
    cfg.exp_name = str(exp_dir)
    cfg.env = dict(cfg.env, collector_env_num=2, evaluator_env_num=2, n_evaluator_episode=2,
                   max_episode_steps=16)
    cfg.policy = dict(cfg.policy, model=dict(MODEL, chance_space_size=32), num_simulations=4,
                      batch_size=16, update_per_collect=3, n_episode=2)
    return Config(cfg)


def test_train_muzero_trains_stochastic_muzero_on_2048_on_the_cpu(tmp_path):
    exp = tmp_path / "exp"
    policy, state, stats = train_muzero(tiny_cfg(exp), seed=0, max_train_iter=6, device="cpu")
    assert isinstance(policy, StochasticMuZeroPolicy)
    assert isinstance(state.model, StochasticMuZeroModel)
    assert stats["train_iter"] == 6 and stats["env_steps"] == 256
    assert stats["eval_env_steps"] == 16  # the eval ends at max_episode_steps
    with open(exp / "log" / "train.jsonl") as f:
        learner = [r for r in map(json.loads, f) if "learner/total_loss" in r]
    assert len(learner) == 2
    for r in learner:
        for key in ("total_loss", "afterstate_policy_loss", "afterstate_value_loss",
                    "commitment_loss"):
            assert np.isfinite(r[f"learner/{key}"]), key
    chance = np.concatenate([e.chance for e in stats["buffer"]._episodes])
    assert chance.max() < 32 and len(np.unique(chance)) > 10
    assert os.path.exists(exp / "ckpt" / "ckpt_final.pt")


def test_without_a_device_the_2048_config_raises_with_no_cuda(tmp_path, monkeypatch):
    from lightzero_tpu_torch.configs.game_2048_stochastic_muzero import main_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = copy.deepcopy(main_config)
    cfg.exp_name = str(tmp_path / "exp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_muzero(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StochasticMuZeroPolicy(cfg.policy)
    assert not os.path.exists(tmp_path / "exp")


def test_2048_config_is_the_zoo_config():
    from lightzero_tpu_torch.configs.game_2048_stochastic_muzero import main_config
    from zoo.game_2048.config.stochastic_muzero_2048_config import main_config as zoo_config

    assert main_config.to_dict() == JaxConfig(zoo_config).to_dict()
