"""Port vs JAX: AlphaZero (lightzero_tpu_torch/{models,policy}/alphazero.py,
ops/board_augment.py, workers/alphazero_workers.py, entry/train_alphazero.py
against their lightzero_tpu counterparts), at small widths on the CPU.

- The model (TicTacToe and Connect4 planes, 1 and 2 res blocks) against
  flax on perturbed params: logits and values to 1e-5; the importer maps
  every parameter both ways, exactly.
- The search (``_forward_collect``) on positions of random games, player 1
  or 2 to move, some a move from the end: with injected Dirichlet noise
  and tie_break 'first' against the JAX policy's ``_recurrent_fn`` searched
  by the JAX ``batch_puct_search`` with the same noise, and without noise
  through both policies' ``_forward_collect``: visit counts equal, root
  values to 1e-5 (float32 network sums in another order).
- The learn step against optax, for the Adam (``adamw``) and the SGD
  (``add_decayed_weights`` -> ``sgd`` with momentum) branches, both after
  ``clip_by_global_norm``: three optimizer steps on the same gradients,
  params to 1e-6 absolute and relative; then a whole learn step, logs to
  1e-5 and the clipped gradients to 5e-6.
- ``get_augmented_data`` against the JAX function on square, pass and
  column layouts: equal arrays.
- A two-iteration ``train_alphazero`` on the CPU (with augmentation), its
  checkpoints, ``eval_alphazero``, one collect of each policy type and of
  Gomoku, and the entry's refusals.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.envs.board.connect4 import Connect4Env as JaxConnect4
from lightzero_tpu.envs.board.tictactoe import TicTacToeEnv as JaxTicTacToe
from lightzero_tpu.models.alphazero import AlphaZeroModel as JaxAlphaZeroModel
from lightzero_tpu.ops.board_augment import get_augmented_data as jax_augment
from lightzero_tpu.policy.alphazero import AlphaZeroPolicy as JaxAlphaZeroPolicy
from lightzero_tpu.policy.alphazero import AZTrainBatch as JaxAZTrainBatch
from lightzero_tpu.policy.alphazero import AZTrainState as JaxAZTrainState
from lightzero_tpu.search import RootOutput as JaxRootOutput
from lightzero_tpu.search import batch_puct_search as jax_search
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.entry import eval_alphazero, train_alphazero
from lightzero_tpu_torch.envs import Connect4Env, TicTacToeEnv
from lightzero_tpu_torch.envs.board.board_utils import BoardState
from lightzero_tpu_torch.models import AlphaZeroModel
from lightzero_tpu_torch.ops.board_augment import get_augmented_data
from lightzero_tpu_torch.policy import AlphaZeroPolicy
from lightzero_tpu_torch.policy.alphazero import AZTrainBatch
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict, state_dict_to_flax

pytestmark = pytest.mark.unittest

TOL = 1e-5
PARAM_ATOL = 1e-6
LR = 0.003
GAMES = {
    "tictactoe": (JaxTicTacToe, TicTacToeEnv, dict(observation_shape=(3, 3, 3), action_space_size=9,
                                                   num_channels=8, num_res_blocks=1)),
    "connect4": (JaxConnect4, Connect4Env, dict(observation_shape=(6, 7, 3), action_space_size=7,
                                                num_channels=8, num_res_blocks=2)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def perturbed(params, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (rng.standard_normal(x.shape) * scale).astype(np.float32), params)


def models(game, seed=0):
    model_cfg = GAMES[game][2]
    flax_model = JaxAlphaZeroModel.from_config(model_cfg)
    params = perturbed(flax_model.init_params(jax.random.PRNGKey(seed)), seed)
    port = AlphaZeroModel.from_config(Config(model_cfg))
    port.load_state_dict(flax_to_state_dict(params))
    return flax_model, params, port


@pytest.mark.parametrize("game", list(GAMES))
def test_model_matches_flax_and_imports_both_ways(game):
    flax_model, params, port = models(game)
    obs = np.random.default_rng(1).random((6,) + GAMES[game][2]["observation_shape"])
    obs = obs.astype(np.float32)
    exp_logits, exp_value = flax_model.apply(params, obs)
    logits, value = port(torch.from_numpy(obs))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(exp_logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(exp_value), rtol=TOL, atol=TOL)
    assert float(value.detach().abs().max()) <= 1.0
    back = state_dict_to_flax(port.state_dict())
    flat_exp = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_exp) == len(flat_got) == len(port.state_dict())
    for path, leaf in flat_exp:
        np.testing.assert_array_equal(flat_got[path], leaf)


def positions(env, n, seed):
    """``n`` positions of random games, a random number of moves in, none
    finished; about a fifth are one move from a finished game."""
    rng = np.random.default_rng(seed)
    cells = env.H * env.W
    state = env.init_state(n, "cpu")
    depth = rng.integers(0, cells - 1, n)
    for m in range(cells):
        legal = env.legal_mask(state).numpy()
        move = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0 for r in legal])
        nxt = env.step_single(state, torch.from_numpy(move))
        keep = torch.from_numpy((m < depth) & legal.any(1)) & ~nxt.done
        state = BoardState(*(torch.where(keep.reshape((n,) + (1,) * (x.dim() - 1)), y, x)
                             for x, y in zip(state, nxt)))
    return state


def policies(game, seed=0, **cfg):
    jax_env_cls, env_cls, model_cfg = GAMES[game]
    pcfg = dict(model=model_cfg, num_simulations=12, **cfg)
    jax_policy = JaxAlphaZeroPolicy(jax_deep_merge(JaxAlphaZeroPolicy.default_config(), pcfg),
                                    jax_env_cls())
    jax_policy.search_cfg = dataclasses.replace(jax_policy.search_cfg, tie_break="first")
    flax_model, params, port_model = models(game, seed)
    port = AlphaZeroPolicy(pcfg, env_cls(), model=port_model, device="cpu")
    port.search_cfg = dataclasses.replace(port.search_cfg, tie_break="first")
    return jax_policy, jax.tree_util.tree_map(jnp.asarray, params), port


@pytest.mark.parametrize("game", list(GAMES))
def test_forward_collect_matches_jax(game):
    jax_policy, params, port = policies(game)
    state = positions(port.env, 8, seed=3)
    assert set(state.to_play.tolist()) == {1, 2}
    js = type(jax_policy.env.init_state())(*(jnp.asarray(x.numpy()) for x in state))
    legal = port.env.legal_mask(state)
    rng = np.random.default_rng(4)
    noise = np.zeros(legal.shape, np.float32)
    for i, row in enumerate(legal.numpy()):
        noise[i, row] = rng.dirichlet(np.full(row.sum(), 0.3))
    got = port._forward_collect(state, 1.0, noise=torch.from_numpy(noise))
    logits, value = jax_policy.model.apply(params, jax.vmap(jax_policy.env.observation)(js))
    exp = jax_search(params, jax.random.PRNGKey(0),
                     JaxRootOutput(prior_logits=logits, value=value, embedding=js),
                     jax_policy._recurrent_fn, jax_policy.search_cfg,
                     jax.vmap(jax_policy.env.legal_mask)(js), to_play=js.to_play,
                     with_noise=True, noise=jnp.asarray(noise))
    np.testing.assert_array_equal(got["visit_counts"].numpy(), np.asarray(exp.visit_counts))
    np.testing.assert_allclose(got["searched_value"].numpy(), np.asarray(exp.root_value),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["predicted_value"].numpy(), np.asarray(value), rtol=TOL, atol=TOL)
    # without noise, through both policies' own collect step
    got = port._forward_collect(state, 1.0, deterministic=True)
    exp = jax_policy._forward_collect(params, jax.random.PRNGKey(1), js, jnp.float32(1.0),
                                      deterministic=True)
    np.testing.assert_array_equal(got["visit_counts"].numpy(), np.asarray(exp["visit_counts"]))
    np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
    np.testing.assert_allclose(got["searched_value"].numpy(), np.asarray(exp["searched_value"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["obs"].numpy(), np.asarray(exp["obs"]))


def test_terminal_value_is_from_the_side_to_move():
    _, _, port = policies("tictactoe")
    s = BoardState(board=torch.tensor([[1, 1, 0, 2, 2, 0, 0, 0, 0]], dtype=torch.int8),
                   to_play=torch.tensor([1], dtype=torch.int32), done=torch.tensor([False]),
                   winner=torch.tensor([0], dtype=torch.int32),
                   t=torch.tensor([4], dtype=torch.int32))
    out = port._recurrent_fn(torch.tensor([2]), s)  # player 1 completes the top row
    assert bool(out.terminal[0]) and float(out.value[0].detach()) == -1.0  # player 2 to move has lost
    assert not out.legal_mask.any()


def _batch(rng):
    obs = rng.random((16, 6, 7, 3)).astype(np.float32)
    target_policy = rng.dirichlet(np.ones(7), 16).astype(np.float32)
    z = rng.choice([-1.0, 0.0, 1.0], 16).astype(np.float32)
    return (AZTrainBatch(torch.from_numpy(obs), torch.from_numpy(target_policy), torch.from_numpy(z)),
            JaxAZTrainBatch(jnp.asarray(obs), jnp.asarray(target_policy), jnp.asarray(z)))


@pytest.mark.parametrize("optim_type", ["Adam", "SGD"])
def test_learn_step_matches_optax(optim_type):
    """Three steps of the optimizer chain on the same gradients (JAX's,
    handed to the port's parameters) against optax: params to 1e-6 absolute
    and relative (AdamW's decay is rounded in another order than optax's).
    Then one whole learn step from the same params: the logs to 1e-5 and the
    clipped gradients to 1e-5 of the clip norm."""
    cfg = dict(optim_type=optim_type, learning_rate=LR, weight_decay=1e-3, grad_clip_value=0.5)
    jax_policy, params, port = policies("connect4", seed=2, **cfg)
    rng = np.random.default_rng(7)
    state = port.init_train_state()
    jstate = JaxAZTrainState(params, jax_policy.optimizer.init(params), jnp.zeros((), jnp.int32))
    for step in range(3):
        _, jbatch = _batch(rng)
        grads = jax.grad(lambda p: jax_policy._loss_fn(p, jbatch)[0])(jstate.params)
        for name, g in flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)).items():
            state.model.get_parameter(name).grad = g.clone()
        norm = port._apply_gradients(state)
        updates, opt_state = jax_policy.optimizer.update(grads, jstate.opt_state, jstate.params)
        jstate = JaxAZTrainState(optax.apply_updates(jstate.params, updates), opt_state,
                                 jstate.train_iter + 1)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=TOL)
        assert float(norm) > 0.5  # the clip is live
        got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(state.model.state_dict())))
        for path, exp in jax.tree_util.tree_leaves_with_path(jstate.params):
            np.testing.assert_allclose(got[path], np.asarray(exp), rtol=PARAM_ATOL,
                                       atol=PARAM_ATOL, err_msg=str(path))
    batch, jbatch = _batch(rng)
    state, logs = port.forward_learn(state, batch)
    assert state.train_iter == 1
    grads = jax.grad(lambda p: jax_policy._loss_fn(p, jbatch)[0])(jstate.params)
    jstate, jlogs = jax_policy._forward_learn(jstate, jbatch)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=TOL, atol=TOL, err_msg=k)
    scale = min(1.0, 0.5 / float(jlogs["grad_norm"]))
    port_grads = state_dict_to_flax({n: p.grad for n, p in state.model.named_parameters()})
    for (path, g), (_, pg) in zip(jax.tree_util.tree_leaves_with_path(grads),
                                  jax.tree_util.tree_leaves_with_path(port_grads)):
        np.testing.assert_allclose(pg, scale * np.asarray(g), rtol=0, atol=TOL * 0.5,
                                   err_msg=str(path))


@pytest.mark.parametrize("h,w,a", [(3, 3, 9), (5, 5, 26), (6, 7, 7), (6, 7, 5)],
                         ids=["cells", "cells_and_pass", "columns", "other"])
def test_augmented_data_matches_jax(h, w, a):
    rng = np.random.default_rng(h * w + a)
    obs = rng.random((h, w, 3)).astype(np.float32)
    probs = rng.dirichlet(np.ones(a)).astype(np.float32)
    got, exp = get_augmented_data(obs, probs, -1.0), jax_augment(obs, probs, -1.0)
    assert len(got) == len(exp) == {9: 8, 26: 8, 7: 2, 5: 1}[a]
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.obs, e.obs)
        np.testing.assert_array_equal(g.probs, e.probs)
        assert g.z == e.z


def tiny_cfg(exp_dir, **policy):
    from lightzero_tpu_torch.configs.tictactoe_alphazero_bot_mode import main_config

    cfg = Config(main_config.to_dict())
    cfg.exp_name = str(exp_dir)
    cfg.env = Config(dict(cfg.env, collector_env_num=4, evaluator_env_num=2, n_evaluator_episode=2))
    cfg.policy = Config(dict(cfg.policy, model=dict(cfg.policy.model, num_channels=8),
                             num_simulations=4, batch_size=16, update_per_collect=1, n_episode=2,
                             eval_freq=1, **policy))
    return cfg


def test_train_alphazero_runs_two_iterations_on_the_cpu(tmp_path):
    cfg = tiny_cfg(tmp_path / "exp", use_augmentation=True)
    policy, state, stats = train_alphazero(cfg, seed=0, max_train_iter=2, device="cpu")
    assert stats["train_iter"] == 2 == state.train_iter
    assert stats["env_steps"] >= 2 * 4 * 16
    assert len(stats["replay"]) % 8 == 0  # every sample as its 8 symmetries
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    with open(tmp_path / "exp" / "log" / "train.txt") as f:
        text = f.read()
    losses = [float(line.split("loss=")[1].split()[0]) for line in text.splitlines()
              if "loss=" in line]
    assert len(losses) == 2 and np.isfinite(losses).all() and text.count("EVAL") == 2
    for name in ("ckpt_best", "params_best", "ckpt_final"):
        assert os.path.exists(tmp_path / "exp" / "ckpt" / f"{name}.pt")
    res = eval_alphazero(cfg, seed=1, model_path=str(tmp_path / "exp" / "ckpt" / "ckpt_final"),
                         n_episodes=3, device="cpu")
    assert len(res["episode_returns"]) == 3 and set(res["episode_returns"]) <= {-1.0, 0.0, 1.0}


GOMOKU_MODEL = dict(observation_shape=(6, 6, 3), action_space_size=36, num_channels=8,
                    num_res_blocks=1)


# the first three cases were refused until slice 17's second half was
# ported; each now builds its policy and takes one collect
@pytest.mark.parametrize("override,match", [
    (dict(policy=dict(type="gumbel_alphazero")), None),
    (dict(policy=dict(type="sampled_alphazero", num_of_sampled_actions=4)), None),
    (dict(env=dict(type="gomoku", env_kwargs=dict(board_size=6, n_in_row=4)),
          policy=dict(model=GOMOKU_MODEL)), None),
    (dict(policy=dict(type="muzero")), "not an AlphaZero policy"),
    (dict(env=dict(type="cartpole")), "not a board env"),
], ids=["gumbel_alphazero", "sampled_alphazero", "gomoku", "muzero", "cartpole"])
def test_train_alphazero_refuses_what_is_not_ported(tmp_path, override, match):
    cfg = tiny_cfg(tmp_path / "exp")
    for key, value in override.items():
        cfg[key] = Config(dict(cfg[key], **value))
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            train_alphazero(cfg, device="cpu")
        return
    policy, state, stats = train_alphazero(cfg, max_env_step=1, device="cpu")
    assert type(policy).__name__.lower().startswith(cfg.policy.get("type", "alphazero")
                                                    .replace("_", ""))
    assert stats["env_steps"] > 0 and len(stats["replay"]) > 0
    assert policy.env.action_space_size == cfg.policy.model.action_space_size


def test_train_alphazero_without_device_raises_with_no_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_alphazero(tiny_cfg(tmp_path / "exp"))
