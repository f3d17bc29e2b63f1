"""Port vs JAX: Gumbel MuZero (lightzero_tpu_torch/search/gumbel.py and
policy/gumbel_muzero.py against lightzero_tpu/search/gumbel.py and
lightzero_tpu/policy/gumbel_muzero.py).

jax.random and torch.Generator streams differ, so each port search is given
the Gumbel table the JAX search draws, rebuilt here from the same key
(``jax.random.split`` once, then ``jax.random.gumbel`` of shape (B, A)).

- sequence_of_considered_visits equals the JAX schedule exactly;
- batch_gumbel_search with the dummy recurrent fn of tests/test_torch_search.py,
  illegal actions in some roots: visit counts and tree structure equal,
  improved policy, root values and children values to 1e-5 (the two
  recurrent fns round tanh/cos differently in the last bit, and the backup
  composes the discounted sums in another order); the expanded nodes'
  raw-logit priors to 1e-4, since the dummy fn's sin(x) of x up to ~50
  turns tanh's last-bit difference into 1e-5;
- the policy on the same small model (latent 16, supports of 21 atoms, the
  flax weights perturbed and carried across): collect and eval actions and
  root visit counts equal, the improved policy and searched values to 1e-5
  (1e-4 for the values: the inverse transform's cancellation,
  tests/test_torch_ops.py);
- train_muzero on a tiny Gumbel config on the CPU; with no GPU and no
  device it, the policy and the search raise; players == 2 runs.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.policy.gumbel_muzero import GumbelMuZeroPolicy as JaxGumbelPolicy
from lightzero_tpu.search.gumbel import GumbelSearchConfig as JaxGumbelConfig
from lightzero_tpu.search.gumbel import batch_gumbel_search as jax_gumbel_search
from lightzero_tpu.search.gumbel import sequence_of_considered_visits as jax_schedule
from lightzero_tpu.search.types import RootOutput as JaxRootOutput
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import train_muzero
from lightzero_tpu_torch.policy import GumbelMuZeroPolicy
from lightzero_tpu_torch.search import RootOutput
from lightzero_tpu_torch.search.gumbel import (
    GumbelSearchConfig,
    batch_gumbel_search,
    sequence_of_considered_visits,
)
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from test_torch_model import perturbed_params
from test_torch_search import A, B, _jax_dummy_recurrent, _torch_dummy_recurrent

pytestmark = pytest.mark.unittest

TOL = 1e-5
VALUE_TOL = 1e-4
MODEL = dict(observation_shape=4, action_space_size=3, model_type="mlp", latent_state_dim=16,
             support_scale=10, self_supervised_learning_loss=True)


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


def jax_gumbel_table(search_rng, shape):
    """The table batch_gumbel_search draws from its ``rng`` (gumbel.py:302-304)."""
    _, g_rng = jax.random.split(search_rng)
    return np.asarray(jax.random.gumbel(g_rng, shape, jnp.float32))


@pytest.mark.parametrize("m,n", [(1, 5), (2, 10), (2, 3), (4, 50), (4, 7), (8, 50), (16, 200),
                                 (3, 31), (5, 16)])
def test_sequence_of_considered_visits_matches_jax(m, n):
    got = sequence_of_considered_visits(m, n)
    exp = jax_schedule(m, n)
    assert got.dtype == exp.dtype and got.shape == (n,)
    np.testing.assert_array_equal(got, exp)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    legal = np.ones((B, A), bool)
    legal[0, 3] = legal[2, 0] = legal[5, 1:3] = False
    return dict(
        prior_logits=rng.standard_normal((B, A)).astype(np.float32),
        value=rng.uniform(-1.0, 1.0, B).astype(np.float32),
        latent=rng.standard_normal((B, 4)).astype(np.float32),
        legal=legal,
    )


@pytest.mark.parametrize("seed,sims,considered", [(0, 12, 4), (1, 30, 2), (2, 9, 8), (3, 16, 1)])
def test_search_matches_jax(seed, sims, considered):
    d = _inputs(seed)
    rng = jax.random.PRNGKey(seed)
    jcfg = JaxGumbelConfig(num_simulations=sims, max_num_considered_actions=considered)
    jroot = JaxRootOutput(prior_logits=jnp.asarray(d["prior_logits"]),
                          value=jnp.asarray(d["value"]),
                          embedding={"latent": jnp.asarray(d["latent"])})
    exp = jax_gumbel_search(None, rng, jroot, _jax_dummy_recurrent, jcfg, jnp.asarray(d["legal"]),
                            to_play=jnp.full((B,), -1, jnp.int32))
    cfg = GumbelSearchConfig(num_simulations=sims, max_num_considered_actions=considered)
    root = RootOutput(prior_logits=torch.from_numpy(d["prior_logits"]),
                      value=torch.from_numpy(d["value"]),
                      embedding={"latent": torch.from_numpy(d["latent"])})
    got = batch_gumbel_search(root, _torch_dummy_recurrent, cfg, torch.from_numpy(d["legal"]),
                              gumbel=torch.tensor(jax_gumbel_table(rng, (B, A))),
                              device="cpu")
    np.testing.assert_array_equal(got.visit_counts.numpy(), np.asarray(exp.visit_counts))
    assert got.visit_counts.sum(1).tolist() == [sims] * B
    np.testing.assert_array_equal(got.tree.children.numpy(), np.asarray(exp.tree.children))
    np.testing.assert_array_equal(got.tree.visit_count.numpy(), np.asarray(exp.tree.visit_count))
    _close(got.improved_policy, exp.improved_policy)
    assert not got.improved_policy[~torch.from_numpy(d["legal"])].any()
    _close(got.root_value, exp.root_value)
    _close(got.root_children_values, exp.root_children_values)
    _close(got.tree.value_sum, exp.tree.value_sum)
    # the tree keeps raw logits as priors, illegal actions at -1e9: the
    # roots' exactly; the expanded nodes' are the dummy fn's sin(x) with x
    # up to ~50, which turns tanh's last-bit difference into 1e-5 absolute
    prior, jprior = got.tree.prior.numpy(), np.asarray(exp.tree.prior)
    np.testing.assert_array_equal(prior[:, 0], jprior[:, 0])
    np.testing.assert_array_equal(prior == -1e9, jprior == -1e9)
    np.testing.assert_allclose(prior, jprior, rtol=0, atol=VALUE_TOL)
    for name in ("vmin", "vmax"):
        _close(getattr(got.tree, name), getattr(exp.tree, name))


def test_search_draws_its_own_gumbel_noise():
    d = _inputs(4)
    cfg = GumbelSearchConfig(num_simulations=8, max_num_considered_actions=4)
    root = RootOutput(prior_logits=torch.from_numpy(d["prior_logits"]),
                      value=torch.from_numpy(d["value"]),
                      embedding={"latent": torch.from_numpy(d["latent"])})
    legal = torch.from_numpy(d["legal"])
    outs = [batch_gumbel_search(root, _torch_dummy_recurrent, cfg, legal,
                                generator=torch.Generator().manual_seed(s), device="cpu")
            for s in (0, 0, 1)]
    assert torch.equal(outs[0].visit_counts, outs[1].visit_counts)
    assert not torch.equal(outs[0].visit_counts, outs[2].visit_counts)
    for out in outs:
        assert out.visit_counts.sum(1).tolist() == [8] * B
        assert not out.visit_counts[~legal].any()


# players == 2 was refused until two-player Gumbel search was ported; each
# case now runs (held against JAX in tests/test_torch_board_gumbel.py)
@pytest.mark.parametrize("path", ["search", "policy"])
def test_players_two_is_refused(path):
    d = _inputs(5)
    to_play = torch.tensor([1, 2, -1, 1, 2, -1, 1, 2], dtype=torch.int32)
    if path == "search":
        root = RootOutput(prior_logits=torch.from_numpy(d["prior_logits"]),
                          value=torch.from_numpy(d["value"]),
                          embedding={"latent": torch.from_numpy(d["latent"])})
        out = batch_gumbel_search(root, _torch_dummy_recurrent,
                                  GumbelSearchConfig(num_simulations=6, players=2),
                                  torch.from_numpy(d["legal"]), to_play=to_play,
                                  generator=torch.Generator().manual_seed(0), device="cpu")
        assert out.visit_counts.sum(1).tolist() == [6] * B
        assert set(out.tree.to_play[:, 1:7].flatten().tolist()) == {-1, 1, 2}
        return
    policy = GumbelMuZeroPolicy(dict(env_type="board_games", model=MODEL, num_simulations=4),
                                device="cpu")
    assert policy.gumbel_cfg.players == 2
    obs = torch.from_numpy(np.random.default_rng(5).standard_normal((B, 4)).astype(np.float32))
    legal = torch.ones((B, 3), dtype=torch.bool)
    out = policy._forward_collect(obs, legal, to_play, 1.0, 0.0)
    assert out["raw_visit_counts"].sum(1).tolist() == [4] * B


def test_search_without_device_raises_with_no_cuda(monkeypatch):
    d = _inputs(6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = RootOutput(prior_logits=torch.from_numpy(d["prior_logits"]),
                      value=torch.from_numpy(d["value"]),
                      embedding={"latent": torch.from_numpy(d["latent"])})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_gumbel_search(root, _torch_dummy_recurrent, GumbelSearchConfig(num_simulations=2),
                            torch.from_numpy(d["legal"]))


def test_default_config_is_the_jax_default():
    assert GumbelMuZeroPolicy.default_config().to_dict() == JaxGumbelPolicy.default_config().to_dict()


@pytest.fixture(scope="module")
def policies():
    cfg = dict(model=MODEL, num_simulations=9, max_num_considered_actions=2)
    jax_policy = JaxGumbelPolicy(jax_deep_merge(JaxGumbelPolicy.default_config(), cfg))
    params = perturbed_params(jax_policy.model, 6)
    port = GumbelMuZeroPolicy(cfg, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    return jax_policy, jax.tree_util.tree_map(jnp.asarray, params), port


@pytest.mark.parametrize("mode", ["collect", "eval"])
def test_policy_actions_match_jax(policies, mode):
    jax_policy, params, port = policies
    rng = np.random.default_rng(7)
    n = 6
    obs = rng.standard_normal((n, 4)).astype(np.float32)
    legal = np.ones((n, 3), bool)
    legal[1, 0] = legal[4, 2] = False
    key = jax.random.PRNGKey(11)
    if mode == "collect":
        exp = jax_policy.forward_collect(params, key, jnp.asarray(obs), jnp.asarray(legal))
    else:
        exp = jax_policy.forward_eval(params, key, jnp.asarray(obs), jnp.asarray(legal))
    # the policy splits its key once before the search splits it again
    table = jax_gumbel_table(jax.random.split(key)[1], (n, 3))
    got = port._forward_collect(torch.from_numpy(obs), torch.from_numpy(legal),
                                torch.full((n,), -1, dtype=torch.int32), 1.0, 0.0,
                                deterministic=mode == "eval", gumbel=torch.tensor(table))
    np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
    assert legal[np.arange(n), got["action"].numpy()].all()
    np.testing.assert_array_equal(got["raw_visit_counts"].numpy(),
                                  np.asarray(exp["raw_visit_counts"]))
    _close(got["visit_counts"], exp["visit_counts"])
    assert got["visit_counts"].dtype == torch.float32
    _close(got["distribution_entropy"], exp["distribution_entropy"])
    for key_ in ("searched_value", "predicted_value", "roots_completed_value"):
        _close(got[key_], exp[key_], VALUE_TOL)


def tiny_cfg(exp_dir):
    return Config(dict(
        exp_name=str(exp_dir),
        env=dict(env_id="CartPole-v0", stop_value=10_000, collector_env_num=2,
                 evaluator_env_num=2, n_evaluator_episode=2),
        policy=dict(type="gumbel_muzero",
                    model=dict(MODEL, action_space_size=2, proj_hid=64, proj_out=64,
                               pred_hid=32, pred_out=64),
                    num_simulations=5, max_num_considered_actions=2, batch_size=16,
                    update_per_collect=4, n_episode=2, eval_freq=1000, ssl_loss_weight=2,
                    reanalyze_ratio=0.25),
    ))


def test_train_muzero_trains_gumbel_muzero_on_the_cpu(tmp_path):
    exp = tmp_path / "exp"
    policy, state, stats = train_muzero(tiny_cfg(exp), seed=0, max_env_step=200, device="cpu")
    assert isinstance(policy, GumbelMuZeroPolicy)
    assert stats["env_steps"] == 256 and stats["train_iter"] == 8
    with open(exp / "log" / "train.jsonl") as f:
        learner = [r for r in map(json.loads, f) if "learner/total_loss" in r]
    assert len(learner) == 2 and all(np.isfinite(r["learner/total_loss"]) for r in learner)
    # the stored policy targets are improved-policy rows, kept as floats
    buffer = stats["buffer"]
    rows = np.concatenate([e.child_visits for e in buffer._episodes])
    assert rows.dtype == np.float32
    np.testing.assert_allclose(rows.sum(-1), 1.0, rtol=1e-5)
    assert ((rows > 0) & (rows < 1)).any() and not np.isin(rows, [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]).all()
    assert os.path.exists(exp / "ckpt" / "ckpt_final.pt")


def test_train_muzero_on_the_cartpole_config_raises_with_no_cuda(tmp_path, monkeypatch):
    from lightzero_tpu_torch.configs.cartpole_gumbel_muzero import main_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = copy.deepcopy(main_config)
    cfg.exp_name = str(tmp_path / "exp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_muzero(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GumbelMuZeroPolicy(cfg.policy)
    assert not os.path.exists(tmp_path / "exp")


def test_cartpole_config_is_the_zoo_config():
    from lightzero_tpu_torch.configs.cartpole_gumbel_muzero import main_config
    from zoo.classic_control.cartpole.config.cartpole_gumbel_muzero_config import (
        main_config as zoo_config,
    )

    assert main_config.to_dict() == JaxConfig(zoo_config).to_dict()
