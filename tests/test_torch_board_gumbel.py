"""Port vs JAX: two-player Gumbel search, the stochastic two-player pUCT
search, and Gumbel and Sampled AlphaZero (lightzero_tpu_torch/search/
{gumbel,puct}.py, policy/{gumbel,sampled}_alphazero.py against their
lightzero_tpu counterparts), on the CPU at small widths.

jax.random and torch.Generator streams differ, so every draw is rebuilt
here from the JAX keys and handed to the port: the Gumbel search's root
table (``jax_gumbel_table``), Sampled AlphaZero's Gumbel-top-K tables (the
root's from the policy's key, one per simulation from the search's key),
the Dirichlet noise and the chance nodes' Gumbel tables.

- ``batch_gumbel_search`` with ``players == 2`` and the dummy recurrent fn
  of tests/test_torch_search.py, roots with player 1, 2 and -1 mixed:
  visit counts, children and the nodes' players equal, improved policy and
  values to 1e-5.
- Gumbel AlphaZero's search on TicTacToe and Connect4 positions (the env as
  the simulator), in self-play roots (player 1 or 2 to move) and in bot-mode
  roots (to_play -1): visit counts and actions equal, improved policy and
  root values to 1e-5.
- A stochastic pUCT search with ``players == 2`` (chance nodes at every
  other level), with injected Dirichlet noise and chance draws: visit
  counts, the tree's links and players equal, values to 1e-5.
- ``gumbel_top_k_mask`` on injected draws: equal masks, including rows
  with fewer than K legal actions.
- Gumbel and Sampled AlphaZero ``_forward_collect`` on Gomoku 6x6 against
  the JAX policies: visit counts (raw ones for Gumbel) and actions equal,
  improved policy and values to 1e-5; one learn step of each against the
  JAX learn step: logs to 1e-5.
- Gumbel MuZero on board games (``env_type`` "board_games", players 2, a
  TicTacToe conv model): collect actions and visit counts equal, values to
  1e-4 (the inverse value transform), the improved policy to that bound
  times the completed-Q scale (50 + 10 visits) * 0.1, 6e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.envs.board.connect4 import Connect4Env as JaxConnect4
from lightzero_tpu.envs.board.gomoku import GomokuEnv as JaxGomoku
from lightzero_tpu.envs.board.tictactoe import TicTacToeEnv as JaxTicTacToe
from lightzero_tpu.models.alphazero import AlphaZeroModel as JaxAlphaZeroModel
from lightzero_tpu.policy.alphazero import AZTrainBatch as JaxAZTrainBatch
from lightzero_tpu.policy.alphazero import AZTrainState as JaxAZTrainState
from lightzero_tpu.policy.gumbel_alphazero import GumbelAlphaZeroPolicy as JaxGumbelAZ
from lightzero_tpu.policy.gumbel_muzero import GumbelMuZeroPolicy as JaxGumbelMuZero
from lightzero_tpu.policy.sampled_alphazero import SampledAlphaZeroPolicy as JaxSampledAZ
from lightzero_tpu.policy.sampled_alphazero import gumbel_top_k_mask as jax_top_k
from lightzero_tpu.search import RootOutput as JaxRootOutput
from lightzero_tpu.search import SearchConfig as JaxSearchConfig
from lightzero_tpu.search import batch_puct_search as jax_search
from lightzero_tpu.search.gumbel import GumbelSearchConfig as JaxGumbelConfig
from lightzero_tpu.search.gumbel import batch_gumbel_search as jax_gumbel_search
from lightzero_tpu.search.types import RecurrentOutput as JaxRecurrentOutput
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.envs import Connect4Env, GomokuEnv, TicTacToeEnv
from lightzero_tpu_torch.models import AlphaZeroModel
from lightzero_tpu_torch.policy import (
    GumbelAlphaZeroPolicy,
    GumbelMuZeroPolicy,
    SampledAlphaZeroPolicy,
)
from lightzero_tpu_torch.policy.alphazero import AZTrainBatch
from lightzero_tpu_torch.policy.sampled_alphazero import gumbel_top_k_mask
from lightzero_tpu_torch.search import RootOutput
from lightzero_tpu_torch.search.gumbel import GumbelSearchConfig, batch_gumbel_search
from lightzero_tpu_torch.search.puct import batch_puct_search
from lightzero_tpu_torch.search.types import RecurrentOutput, SearchConfig
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from test_torch_alphazero import perturbed, positions
from test_torch_model import perturbed_params
from test_torch_search import A, B, _inputs, _jax_dummy_recurrent, _torch_dummy_recurrent
from test_torch_stochastic import jax_chance_tables

pytestmark = pytest.mark.unittest

TOL = 1e-5
VALUE_TOL = 1e-4
GAMES = {
    "tictactoe": (JaxTicTacToe, TicTacToeEnv, dict(observation_shape=(3, 3, 3), action_space_size=9,
                                                   num_channels=8, num_res_blocks=1)),
    "connect4": (JaxConnect4, Connect4Env, dict(observation_shape=(6, 7, 3), action_space_size=7,
                                                num_channels=8, num_res_blocks=1)),
    "gomoku": (lambda: JaxGomoku(board_size=6, n_in_row=4), lambda: GomokuEnv(6, 4),
               dict(observation_shape=(6, 6, 3), action_space_size=36, num_channels=8,
                    num_res_blocks=1)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, exp, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(exp), rtol=tol, atol=tol)


def jax_gumbel_table(search_rng, shape):
    """The table batch_gumbel_search draws from its ``rng`` (gumbel.py:302-304)."""
    _, g_rng = jax.random.split(search_rng)
    return np.asarray(jax.random.gumbel(g_rng, shape, jnp.float32))


def _roots(d, jax_side):
    if jax_side:
        return JaxRootOutput(prior_logits=jnp.asarray(d["prior_logits"]),
                             value=jnp.asarray(d["value"]),
                             embedding={"latent": jnp.asarray(d["latent"])})
    return RootOutput(prior_logits=torch.from_numpy(d["prior_logits"]),
                      value=torch.from_numpy(d["value"]),
                      embedding={"latent": torch.from_numpy(d["latent"])})


@pytest.mark.parametrize("seed,sims,considered", [(0, 12, 4), (1, 20, 2), (2, 9, 8)])
def test_two_player_gumbel_search_matches_jax(seed, sims, considered):
    d = _inputs(seed)
    to_play = np.array([1, 2, -1, 1, 2, 2, -1, 1], np.int32)
    rng = jax.random.PRNGKey(seed)
    exp = jax_gumbel_search(None, rng, _roots(d, True), _jax_dummy_recurrent,
                            JaxGumbelConfig(num_simulations=sims,
                                            max_num_considered_actions=considered, players=2),
                            jnp.asarray(d["legal"]), to_play=jnp.asarray(to_play))
    got = batch_gumbel_search(_roots(d, False), _torch_dummy_recurrent,
                              GumbelSearchConfig(num_simulations=sims,
                                                 max_num_considered_actions=considered, players=2),
                              torch.from_numpy(d["legal"]), to_play=torch.from_numpy(to_play),
                              gumbel=torch.tensor(jax_gumbel_table(rng, (B, A))), device="cpu")
    np.testing.assert_array_equal(got.visit_counts.numpy(), np.asarray(exp.visit_counts))
    np.testing.assert_array_equal(got.tree.children.numpy(), np.asarray(exp.tree.children))
    np.testing.assert_array_equal(got.tree.to_play.numpy(), np.asarray(exp.tree.to_play))
    _close(got.improved_policy, exp.improved_policy)
    _close(got.root_value, exp.root_value)
    _close(got.root_children_values, exp.root_children_values)
    _close(got.tree.value_sum, exp.tree.value_sum)
    # the players-2 branch is live: the same search with one-player signs
    # differs
    one = batch_gumbel_search(_roots(d, False), _torch_dummy_recurrent,
                              GumbelSearchConfig(num_simulations=sims,
                                                 max_num_considered_actions=considered),
                              torch.from_numpy(d["legal"]), to_play=torch.from_numpy(to_play),
                              gumbel=torch.tensor(jax_gumbel_table(rng, (B, A))), device="cpu")
    assert not torch.allclose(one.tree.value_sum, got.tree.value_sum)


def models(game, seed=0):
    model_cfg = GAMES[game][2]
    flax_model = JaxAlphaZeroModel.from_config(model_cfg)
    params = perturbed(flax_model.init_params(jax.random.PRNGKey(seed)), seed)
    port = AlphaZeroModel.from_config(Config(model_cfg))
    port.load_state_dict(flax_to_state_dict(params))
    return params, port


def az_policies(jax_cls, cls, game, seed=0, **cfg):
    jax_env_cls, env_cls, model_cfg = GAMES[game]
    pcfg = dict(model=model_cfg, **cfg)
    jax_policy = jax_cls(jax_deep_merge(jax_cls.default_config(), pcfg), jax_env_cls())
    jax_policy.search_cfg = dataclasses.replace(jax_policy.search_cfg, tie_break="first")
    params, port_model = models(game, seed)
    port = cls(pcfg, env_cls(), model=port_model, device="cpu")
    port.search_cfg = dataclasses.replace(port.search_cfg, tie_break="first")
    return jax_policy, jax.tree_util.tree_map(jnp.asarray, params), port


def _jax_state(jax_policy, state):
    return type(jax_policy.env.init_state())(*(jnp.asarray(x.numpy()) for x in state))


@pytest.mark.parametrize("roots", ["self_play", "bot_mode"])
@pytest.mark.parametrize("game", ["tictactoe", "connect4"])
def test_gumbel_alphazero_search_matches_jax(game, roots):
    """Self-play roots through both policies' collect step; bot-mode roots
    (to_play -1 while the env moves for its own player) through both
    packages' Gumbel search with the policies' recurrent fns."""
    jax_policy, params, port = az_policies(JaxGumbelAZ, GumbelAlphaZeroPolicy, game,
                                           num_simulations=12, max_num_considered_actions=4)
    state = positions(port.env, 8, seed=5)
    assert set(state.to_play.tolist()) == {1, 2}
    js = _jax_state(jax_policy, state)
    key = jax.random.PRNGKey(3)
    if roots == "self_play":
        exp = jax_policy._forward_collect(params, key, js, jnp.float32(1.0))
        table = jax_gumbel_table(jax.random.split(key)[1], (8, port.env.action_space_size))
        got = port._forward_collect(state, 1.0, gumbel=torch.tensor(table))
        np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
        np.testing.assert_array_equal(got["raw_visit_counts"].numpy(),
                                      np.asarray(exp["raw_visit_counts"]))
        _close(got["visit_counts"], exp["visit_counts"])
        _close(got["searched_value"], exp["searched_value"])
        _close(got["predicted_value"], exp["predicted_value"])
        return
    legal = jax.vmap(jax_policy.env.legal_mask)(js)
    logits, value = jax_policy.model.apply(params, jax.vmap(jax_policy.env.observation)(js))
    exp = jax_gumbel_search(params, key, JaxRootOutput(prior_logits=logits, value=value,
                                                       embedding=js),
                            jax_policy._recurrent_fn, jax_policy.gumbel_cfg, legal,
                            to_play=jnp.full((8,), -1, jnp.int32))
    root = RootOutput(prior_logits=torch.tensor(np.array(logits)),
                      value=torch.tensor(np.array(value)), embedding=state)
    got = batch_gumbel_search(root, port._recurrent_fn, port.gumbel_cfg,
                              torch.tensor(np.array(legal)),
                              to_play=torch.full((8,), -1, dtype=torch.int32),
                              gumbel=torch.tensor(jax_gumbel_table(key, legal.shape)),
                              device="cpu")
    assert (got.tree.to_play == -1).all()
    np.testing.assert_array_equal(got.visit_counts.numpy(), np.asarray(exp.visit_counts))
    np.testing.assert_array_equal(got.tree.children.numpy(), np.asarray(exp.tree.children))
    _close(got.improved_policy, exp.improved_policy)
    _close(got.root_value, exp.root_value)


def _jax_chance_recurrent(params, rng, action, embedding):
    """The dummy recurrent fn, every other level a chance node."""
    out = _jax_dummy_recurrent(params, rng, action, {"latent": embedding["latent"]})
    parity = 1.0 - embedding["parity"]
    return out._replace(embedding={"latent": out.embedding["latent"], "parity": parity},
                        is_chance=parity > 0.5)


def _torch_chance_recurrent(action, embedding):
    out = _torch_dummy_recurrent(action, {"latent": embedding["latent"]})
    parity = 1.0 - embedding["parity"]
    return out._replace(embedding={"latent": out.embedding["latent"], "parity": parity},
                        is_chance=parity > 0.5)


def test_stochastic_two_player_search_matches_jax():
    """Chance nodes in a two-player tree, the player flipping at every level
    (no zoo policy reaches this path: Stochastic MuZero pins players to 1,
    so it is held at search level)."""
    d = _inputs(7)
    sims = 14
    to_play = np.array([1, 2, -1, 2, 1, 1, -1, 2], np.int32)
    key = jax.random.PRNGKey(7)
    jroot = JaxRootOutput(prior_logits=jnp.asarray(d["prior_logits"]),
                          value=jnp.asarray(d["value"]),
                          embedding={"latent": jnp.asarray(d["latent"]),
                                     "parity": jnp.zeros((B,), jnp.float32)})
    exp = jax_search(None, key, jroot, _jax_chance_recurrent,
                     JaxSearchConfig(num_simulations=sims, tie_break="first", players=2,
                                     stochastic=True),
                     jnp.asarray(d["legal"]), to_play=jnp.asarray(to_play),
                     noise=jnp.asarray(d["noise"]))
    root = RootOutput(prior_logits=torch.from_numpy(d["prior_logits"]),
                      value=torch.from_numpy(d["value"]),
                      embedding={"latent": torch.from_numpy(d["latent"]),
                                 "parity": torch.zeros(B)})
    got = batch_puct_search(root, _torch_chance_recurrent,
                            SearchConfig(num_simulations=sims, tie_break="first", players=2,
                                         stochastic=True),
                            torch.from_numpy(d["legal"]), to_play=torch.from_numpy(to_play),
                            noise=torch.from_numpy(d["noise"]),
                            chance_noise=jax_chance_tables(key, sims, (sims + 2, B, A)),
                            device="cpu")
    assert got.tree.is_chance.any() and (got.tree.to_play == 2).any()
    np.testing.assert_array_equal(got.tree.is_chance.numpy(), np.asarray(exp.tree.is_chance))
    np.testing.assert_array_equal(got.visit_counts.numpy(), np.asarray(exp.visit_counts))
    np.testing.assert_array_equal(got.tree.children.numpy(), np.asarray(exp.tree.children))
    np.testing.assert_array_equal(got.tree.to_play.numpy(), np.asarray(exp.tree.to_play))
    _close(got.root_value, exp.root_value)
    _close(got.tree.value_sum, exp.tree.value_sum)


@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_gumbel_top_k_mask_matches_jax(k):
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((16, 8)).astype(np.float32)
    legal = rng.random((16, 8)) < 0.6
    legal[0] = False
    legal[1, :2] = True
    key = jax.random.PRNGKey(k)
    g = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    exp = jax_top_k(key, jnp.asarray(logits), jnp.asarray(legal), k)
    got = gumbel_top_k_mask(torch.from_numpy(logits), torch.from_numpy(legal), k,
                            torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    few = legal.sum(1) <= k
    assert (got.numpy()[few] == legal[few]).all()
    assert (got.numpy()[~few].sum(1) == k).all()


def _sampled_draws(key, sims, shape):
    """Sampled AlphaZero's Gumbel tables: the policy splits its key four
    ways (sampled_alphazero.py:326), the root's table from the second; the
    search splits the third once for the root noise, then three ways per
    simulation, the recurrent fn's table from the third (puct.py:781-790)."""
    _, k_rng, s_rng, _ = jax.random.split(key, 4)
    root = np.asarray(jax.random.gumbel(k_rng, shape, jnp.float32))
    rng, _ = jax.random.split(s_rng)
    sim = []
    for _ in range(sims):
        rng, _, m_rng = jax.random.split(rng, 3)
        sim.append(np.asarray(jax.random.gumbel(m_rng, shape, jnp.float32)))
    return torch.tensor(root), torch.from_numpy(np.stack(sim))


def _learn_batch(rng, A):
    obs = rng.random((16, 6, 6, 3)).astype(np.float32)
    target = rng.dirichlet(np.ones(A), 16).astype(np.float32)
    z = rng.choice([-1.0, 0.0, 1.0], 16).astype(np.float32)
    return (AZTrainBatch(torch.from_numpy(obs), torch.from_numpy(target), torch.from_numpy(z)),
            JaxAZTrainBatch(jnp.asarray(obs), jnp.asarray(target), jnp.asarray(z)))


def _learn_step_matches(jax_policy, params, port, seed):
    """One learn step of each package from the same params and batch: the
    logs to 1e-5."""
    batch, jbatch = _learn_batch(np.random.default_rng(seed), port.env.action_space_size)
    state, logs = port.forward_learn(port.init_train_state(), batch)
    jstate = JaxAZTrainState(params, jax_policy.optimizer.init(params), jnp.zeros((), jnp.int32))
    _, jlogs = jax_policy._forward_learn(jstate, jbatch)
    assert state.train_iter == 1
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("kind", ["gumbel", "sampled"])
def test_gomoku_alphazero_variants_collect_and_learn_like_jax(kind):
    if kind == "gumbel":
        jax_policy, params, port = az_policies(JaxGumbelAZ, GumbelAlphaZeroPolicy, "gomoku",
                                               num_simulations=16, max_num_considered_actions=8)
    else:
        jax_policy, params, port = az_policies(JaxSampledAZ, SampledAlphaZeroPolicy, "gomoku",
                                               num_simulations=16, num_of_sampled_actions=6)
    state = positions(port.env, 6, seed=9)
    js = _jax_state(jax_policy, state)
    key = jax.random.PRNGKey(4)
    for deterministic in (False, True):
        exp = jax_policy._forward_collect(params, key, js, jnp.float32(1.0),
                                          deterministic=deterministic)
        if kind == "gumbel":
            table = jax_gumbel_table(jax.random.split(key)[1], (6, 36))
            got = port._forward_collect(state, 1.0, deterministic, gumbel=torch.tensor(table))
            np.testing.assert_array_equal(got["raw_visit_counts"].numpy(),
                                          np.asarray(exp["raw_visit_counts"]))
            _close(got["visit_counts"], exp["visit_counts"])
            np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
        else:
            root_g, sim_g = _sampled_draws(key, 16, (6, 36))
            if not deterministic:
                # the root's Dirichlet noise: JAX draws it; compared below
                # through the search with the same noise
                continue
            got = port._forward_collect(state, 1.0, True, root_gumbel=root_g, sim_gumbel=sim_g)
            np.testing.assert_array_equal(got["visit_counts"].numpy(),
                                          np.asarray(exp["visit_counts"]))
            np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
            # at most K root actions searched
            assert ((got["visit_counts"] > 0).sum(1) <= 6).all()
        _close(got["searched_value"], exp["searched_value"])
        _close(got["predicted_value"], exp["predicted_value"])
    if kind == "sampled":
        # with root noise: the JAX search with the same Dirichlet noise and
        # the same subsets
        legal = port.env.legal_mask(state)
        rng = np.random.default_rng(2)
        root_g, sim_g = _sampled_draws(key, 16, (6, 36))
        logits, value = jax_policy.model.apply(params, jax.vmap(jax_policy.env.observation)(js))
        root_legal = gumbel_top_k_mask(torch.tensor(np.array(logits)), legal, 6, root_g)
        noise = np.zeros(legal.shape, np.float32)
        for i, row in enumerate(root_legal.numpy()):
            noise[i, row] = rng.dirichlet(np.full(row.sum(), 0.3))
        got = port._forward_collect(state, 1.0, noise=torch.from_numpy(noise),
                                    root_gumbel=root_g, sim_gumbel=sim_g)
        _, _, s_rng, _ = jax.random.split(key, 4)
        exp = jax_search(params, s_rng, JaxRootOutput(prior_logits=logits, value=value,
                                                      embedding=js),
                         jax_policy._recurrent_fn, jax_policy.search_cfg,
                         jnp.asarray(root_legal.numpy()), to_play=js.to_play, with_noise=True,
                         noise=jnp.asarray(noise))
        np.testing.assert_array_equal(got["visit_counts"].numpy(), np.asarray(exp.visit_counts))
        _close(got["searched_value"], exp.root_value)
    _learn_step_matches(jax_policy, params, port, seed=3)


def test_gumbel_muzero_on_a_board_game_matches_jax():
    """Gumbel MuZero with env_type "board_games": players 2 in the policy's
    Gumbel search, self-play roots (player 1 or 2) and bot-mode roots (-1)
    in one batch."""
    model = dict(observation_shape=(3, 3, 3), action_space_size=9, model_type="conv",
                 num_channels=8, num_res_blocks=1, downsample=False, support_scale=10)
    cfg = dict(env_type="board_games", model=model, num_simulations=10,
               max_num_considered_actions=4, discount_factor=1.0)
    jax_policy = JaxGumbelMuZero(jax_deep_merge(JaxGumbelMuZero.default_config(), cfg))
    assert jax_policy.gumbel_cfg.players == 2
    params = perturbed_params(jax_policy.model, 3)
    port = GumbelMuZeroPolicy(cfg, device="cpu")
    assert port.gumbel_cfg.players == 2
    port.model.load_state_dict(flax_to_state_dict(params))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    env = TicTacToeEnv()
    state = positions(env, 6, seed=2)
    obs, legal = env.observation(state).numpy(), env.legal_mask(state).numpy()
    to_play = np.array([1, 2, -1, 2, 1, -1], np.int32)
    key = jax.random.PRNGKey(5)
    exp = jax_policy.forward_collect(params, key, jnp.asarray(obs), jnp.asarray(legal),
                                     to_play=jnp.asarray(to_play))
    table = jax_gumbel_table(jax.random.split(key)[1], legal.shape)
    got = port._forward_collect(torch.from_numpy(obs), torch.from_numpy(legal),
                                torch.from_numpy(to_play), 1.0, 0.0, gumbel=torch.tensor(table))
    np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
    np.testing.assert_array_equal(got["raw_visit_counts"].numpy(),
                                  np.asarray(exp["raw_visit_counts"]))
    for k in ("searched_value", "predicted_value"):
        _close(got[k], exp[k], VALUE_TOL)
    # the improved policy takes softmax(logits + sigma(Q)), sigma scaling the
    # values by (maxvisit_init 50 + max visits) * value_scale 0.1, so the
    # values' bound carries over times that scale
    _close(got["visit_counts"], exp["visit_counts"], VALUE_TOL * (50 + 10) * 0.1)
