"""The rest of slice 17 through the port's entries on the CPU: Gomoku, Go
and Chess, Gumbel and Sampled AlphaZero, and the board policy types of
``train_muzero``.

- The fifteen board configs this slice copies into
  lightzero_tpu_torch/configs/ equal the zoo files key for key, and each
  builds through ``compile_config`` with its policy's defaults.
- ``train_alphazero`` shrunk (8 channels, 4 simulations, batch 16, games cut
  at ``max_moves``) on Go 6x6 (AlphaZero), Gomoku (Gumbel and Sampled
  AlphaZero) and Chess (AlphaZero): learn steps taken, finite losses, the
  stored targets distributions over legal moves; the Go run's dihedral
  augmentation keeps the pass action in place.
- ``train_muzero`` shrunk on the Gomoku, Go and Chess MuZero configs, Gumbel
  MuZero on TicTacToe (players 2), and the TicTacToe v2 and Connect4 aug,
  resume and ReZero configs. The Gomoku MuZero and Connect4 ReZero configs
  leave ``downsample`` at its default, which downsamples their boards to
  nothing: the JAX entry fails on them (ZeroDivisionError), the port
  refuses them with a ValueError, and they train with downsample=False.
- The board policy types: ``train_muzero`` runs on a board game exactly the
  types that the JAX entry runs there (muzero, efficientzero, gumbel_muzero,
  muzero_context, found by running each type through the JAX
  ``train_muzero`` on a shrunk TicTacToe bot-mode config); it refuses the
  others with a ValueError that names the JAX failure. The sampled
  policies' failure is shown here: their actions are float arrays, with
  which the JAX board env cannot index its board (ROADMAP queue 3).
- Go self-play games that end on the loser's move are labelled draws by
  the JAX collector (it reads the winner off a positive final reward); the
  port's collector labels them the same way (ROADMAP queue 3).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.envs.board.go import GoEnv as JaxGoEnv
from lightzero_tpu.envs.board.tictactoe import TicTacToeEnv as JaxTicTacToe
from lightzero_tpu.workers.alphazero_workers import (
    AlphaZeroSelfPlayCollector as JaxSelfPlayCollector,
)
from lightzero_tpu_torch.config import Config, compile_config
from lightzero_tpu_torch.entry import train_alphazero, train_muzero
from lightzero_tpu_torch.entry.train_alphazero import POLICIES as AZ_POLICIES
from lightzero_tpu_torch.entry.train_muzero import BOARD_POLICIES, JAX_BOARD_FAULTS
from lightzero_tpu_torch.entry.train_muzero import POLICIES as MZ_POLICIES
from lightzero_tpu_torch.envs import GoEnv
from lightzero_tpu_torch.workers.alphazero_workers import AlphaZeroSelfPlayCollector

pytestmark = pytest.mark.unittest

CONFIGS = {
    "gomoku_alphazero_bot_mode": "gomoku.config.gomoku_alphazero_bot_mode_config",
    "gomoku_gumbel_alphazero": "gomoku.config.gomoku_gumbel_alphazero_config",
    "gomoku_muzero_bot_mode": "gomoku.config.gomoku_muzero_bot_mode_config",
    "gomoku_sampled_alphazero_bot_mode": "gomoku.config.gomoku_sampled_alphazero_bot_mode_config",
    "go6_alphazero_bot_mode": "go.config.go6_alphazero_bot_mode_config",
    "go_alphazero_bot_mode": "go.config.go_alphazero_bot_mode_config",
    "go_alphazero_sp_mode": "go.config.go_alphazero_sp_mode_config",
    "go_muzero_bot_mode": "go.config.go_muzero_bot_mode_config",
    "chess_alphazero_bot_mode": "chess.config.chess_alphazero_bot_mode_config",
    "chess_muzero_bot_mode": "chess.config.chess_muzero_bot_mode_config",
    "tictactoe_gumbel_alphazero": "tictactoe.config.tictactoe_gumbel_alphazero_config",
    "tictactoe_muzero_v2": "tictactoe.config.tictactoe_muzero_v2_config",
    "connect4_muzero_aug": "connect4.config.connect4_muzero_aug_config",
    "connect4_muzero_resume": "connect4.config.connect4_muzero_resume_config",
    "connect4_rezero_mz_bot_mode": "connect4.config.connect4_rezero_mz_bot_mode_config",
}
# the zoo configs that leave downsample at its default on a 6x6 or 6x7
# board, which it downsamples to nothing: the JAX entry raises
# ZeroDivisionError building the model (ROADMAP queue 3)
DOWNSAMPLED_TO_NOTHING = ("gomoku_muzero_bot_mode", "connect4_rezero_mz_bot_mode")
ALPHAZERO = {"gomoku_alphazero_bot_mode", "gomoku_gumbel_alphazero",
             "gomoku_sampled_alphazero_bot_mode", "go6_alphazero_bot_mode",
             "go_alphazero_bot_mode", "go_alphazero_sp_mode", "chess_alphazero_bot_mode",
             "tictactoe_gumbel_alphazero"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(name):
    return importlib.import_module(f"lightzero_tpu_torch.configs.{name}").main_config


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_equals_the_zoo_file_and_builds(name, tmp_path):
    zoo = importlib.import_module(f"zoo.board_games.{CONFIGS[name]}").main_config
    assert port_config(name).to_dict() == JaxConfig(zoo).to_dict()
    cfg = Config(port_config(name).to_dict())
    cfg.exp_name = str(tmp_path / "exp")
    policies = AZ_POLICIES if name in ALPHAZERO else MZ_POLICIES
    default = "alphazero" if name in ALPHAZERO else "muzero"
    policy_cls = policies[cfg.policy.get("type", default)]
    built = compile_config(cfg, policy_cls.default_config(), seed=0)
    assert (tmp_path / "exp" / "total_config.json").exists()
    assert built.policy.type == cfg.policy.get("type", default)
    assert built.policy.num_simulations == cfg.policy.num_simulations


def shrunk(name, exp_dir, max_moves=None, **policy):
    cfg = Config(port_config(name).to_dict())
    cfg.exp_name = str(exp_dir)
    env = dict(cfg.env, collector_env_num=2, evaluator_env_num=2, n_evaluator_episode=2,
               stop_value=10_000)
    if max_moves:
        env["max_moves"] = max_moves
    if name.startswith("chess"):
        # a chess step plays all 4672 moves of each board several times
        # over (legality, the bot): one env each way keeps the run short
        env.update(collector_env_num=1, evaluator_env_num=1, n_evaluator_episode=1)
    cfg.env = Config(env)
    model = dict(cfg.policy.model, num_channels=8)
    if name not in ALPHAZERO:
        model.update(proj_hid=64, proj_out=64, pred_hid=32, pred_out=64)
    cfg.policy = Config(dict(cfg.policy, model=model, batch_size=16, update_per_collect=2,
                             n_episode=2, eval_freq=1, **dict(dict(num_simulations=4), **policy)))
    return cfg


@pytest.mark.parametrize("name,max_moves", [
    ("go6_alphazero_bot_mode", 12),
    ("gomoku_gumbel_alphazero", None),
    ("gomoku_sampled_alphazero_bot_mode", None),
    ("chess_alphazero_bot_mode", 6),
])
def test_train_alphazero_runs_shrunk(tmp_path, name, max_moves):
    cfg = shrunk(name, tmp_path / "exp", max_moves)
    policy, state, stats = train_alphazero(cfg, seed=0, max_train_iter=2, device="cpu")
    assert type(policy) is AZ_POLICIES[cfg.policy.get("type", "alphazero")]
    assert stats["train_iter"] == 2 == state.train_iter and stats["env_steps"] > 0
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    probs = np.stack([s.probs for s in stats["replay"]])
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    assert probs.shape[1] == policy.env.action_space_size
    assert set(s.z for s in stats["replay"]) <= {-1.0, 0.0, 1.0}
    if name.startswith("go6"):
        # the 8 dihedral copies of a sample share its pass probability
        assert len(stats["replay"]) % 8 == 0
        orbit = probs[:8, -1]
        assert (orbit == orbit[0]).all()
    if "gumbel" in name:
        # improved-policy targets, not visit fractions
        assert not np.isin(probs, np.arange(5) / 4).all()


@pytest.mark.parametrize("name,max_moves,policy", [
    ("gomoku_muzero_bot_mode", None, {}),
    ("go_muzero_bot_mode", 10, {}),
    # players 1 (the config sets no env_type): the descent's plain version
    # on the CPU sums 4672 children in order, so 2 simulations only
    ("chess_muzero_bot_mode", 4, dict(num_simulations=2)),
    ("tictactoe_muzero_v2", None, dict(type="gumbel_muzero")),
    ("tictactoe_muzero_v2", None, {}),
    ("connect4_muzero_aug", None, {}),
    ("connect4_muzero_resume", None, {}),
    ("connect4_rezero_mz_bot_mode", None, dict(reanalyze_batch_size=8)),
], ids=["gomoku", "go", "chess", "tictactoe_gumbel", "tictactoe_v2", "connect4_aug",
        "connect4_resume", "connect4_rezero"])
def test_train_muzero_runs_board_configs_shrunk(tmp_path, name, max_moves, policy):
    cfg = shrunk(name, tmp_path / "exp", max_moves, **policy)
    if name in DOWNSAMPLED_TO_NOTHING:
        with pytest.raises(ValueError, match="downsample"):
            train_muzero(cfg, device="cpu")
        cfg.policy.model = dict(cfg.policy.model, downsample=False)
    out_policy, state, stats = train_muzero(cfg, seed=0, max_train_iter=2, device="cpu")
    assert stats["train_iter"] == 2 == state.train_iter
    assert type(out_policy) is MZ_POLICIES[cfg.policy.get("type", "muzero")]
    assert out_policy.players == (2 if cfg.policy.get("env_type") == "board_games" else 1)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert stats["buffer"].num_transitions >= 16


def test_board_policy_types_are_the_ones_the_jax_entry_runs():
    assert set(BOARD_POLICIES) | set(JAX_BOARD_FAULTS) == set(MZ_POLICIES)
    assert not set(BOARD_POLICIES) & set(JAX_BOARD_FAULTS)
    # UniZero and Sampled UniZero (discrete) run on a TicTacToe bot-mode
    # config through the JAX entry too (tests/test_torch_unizero_train.py)
    assert set(BOARD_POLICIES) == {"muzero", "efficientzero", "gumbel_muzero", "muzero_context",
                                   "unizero", "sampled_unizero"}


@pytest.mark.parametrize("policy_type", sorted(JAX_BOARD_FAULTS))
def test_train_muzero_refuses_the_board_types_that_fail_in_jax(tmp_path, policy_type):
    cfg = shrunk("tictactoe_muzero_v2", tmp_path / "exp", type=policy_type)
    with pytest.raises(ValueError, match="JAX"):
        train_muzero(cfg, device="cpu")


def test_the_jax_sampled_policys_float_actions_cannot_step_a_board():
    """What the JAX entry meets with a sampled policy on a board game: the
    policy's actions are float arrays (continuous-action layout) and the
    board env's step_single indexes its board with them."""
    from lightzero_tpu.config.core import deep_merge as jax_deep_merge
    from lightzero_tpu.policy.sampled_muzero import SampledMuZeroPolicy as JaxSampled

    pcfg = jax_deep_merge(JaxSampled.default_config(), dict(
        env_type="board_games", num_simulations=2,
        model=dict(port_config("tictactoe_muzero_v2").policy.model, num_channels=4)))
    jax_policy = JaxSampled(pcfg)
    params = jax_policy.init_train_state(jax.random.PRNGKey(0)).params
    env = JaxTicTacToe("play_with_bot_mode")
    s = env.init_state()
    out = jax_policy.forward_eval(params, jax.random.PRNGKey(1),
                                  env.observation(s)[None], env.legal_mask(s)[None])
    assert jnp.issubdtype(out["action"].dtype, jnp.floating)
    with pytest.raises(TypeError, match="Indexer must have integer"):
        env.step_single(s, out["action"][0])


class _PassAfterOneStone:
    """A stub AlphaZero policy for Go: black plays the centre, white
    passes; with max_moves 2 each game ends on white's pass, lost by white
    (black's stone owns the board)."""

    def __init__(self, jax_side):
        self.jax_side = jax_side
        self.device = torch.device("cpu")

    def _forward_collect(self, *args, **kwargs):
        s = args[2] if self.jax_side else args[0]
        xp = jnp if self.jax_side else torch
        action = xp.where(s.to_play == 1, 12, 25)
        visits = (xp.arange(26)[None, :] == action[:, None]) * 1.0
        obs = xp.zeros((s.board.shape[0], 5, 5, 3))
        return dict(action=action, visit_counts=visits, obs=obs)


def test_go_games_lost_on_the_last_move_are_labelled_draws_as_in_jax():
    env = GoEnv(board_size=5, komi=0.5, max_moves=2)
    step = env.transition(env.init_state(1, "cpu"), torch.tensor([12]), torch.zeros(1, 25))
    step = env.transition(step.state, torch.tensor([25]), torch.zeros(1, 25))
    assert bool(step.done[0]) and float(step.reward[0]) == -1.0  # white, the mover, lost
    got, _ = AlphaZeroSelfPlayCollector(env, _PassAfterOneStone(False), 2,
                                        rollout_length=2).collect(num_episodes=2)
    jenv = JaxGoEnv(board_size=5, komi=0.5, max_moves=2)
    exp, _ = JaxSelfPlayCollector(jenv, _PassAfterOneStone(True), 2,
                                  rollout_length=2).collect(None, num_episodes=2)
    assert [s.z for s in got] == [s.z for s in exp] == [0.0] * 4
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.probs, e.probs)


@pytest.mark.parametrize("name", ["go6_alphazero_bot_mode", "chess_alphazero_bot_mode"])
def test_alphazero_importer_carries_the_zoo_widths(name):
    """The AlphaZero map at Go 6x6's width (64 channels, 2 res blocks, 37
    actions) and Chess's (96 channels, 6 res blocks, 4672 actions): every
    flax parameter carried across and back exactly, logits and values of
    the imported model to 1e-5 of flax's."""
    from lightzero_tpu.models.alphazero import AlphaZeroModel as JaxAlphaZeroModel
    from lightzero_tpu_torch.models import AlphaZeroModel
    from lightzero_tpu_torch.utils.params_import import flax_to_state_dict, state_dict_to_flax
    from test_torch_alphazero import perturbed

    model_cfg = port_config(name).policy.model.to_dict()
    flax_model = JaxAlphaZeroModel.from_config(model_cfg)
    params = perturbed(flax_model.init_params(jax.random.PRNGKey(0)), 1, scale=0.05)
    port = AlphaZeroModel.from_config(Config(model_cfg))
    port.load_state_dict(flax_to_state_dict(params))
    assert len(port.res) == model_cfg["num_res_blocks"]
    obs = np.random.default_rng(2).random((3,) + tuple(model_cfg["observation_shape"]))
    obs = obs.astype(np.float32)
    exp_logits, exp_value = flax_model.apply(params, obs)
    with torch.no_grad():
        logits, value = port(torch.from_numpy(obs))
    assert logits.shape == (3, model_cfg["action_space_size"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(exp_logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(exp_value), rtol=1e-5, atol=1e-5)
    back = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(port.state_dict())))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == len(back) == len(port.state_dict())
    for path, leaf in leaves:
        np.testing.assert_array_equal(back[path], leaf)


def test_committed_go6_params_match_flax_in_the_port():
    """The committed Go 6x6 AlphaZero params (orbax, read with the JAX
    package's reader) through the importer: the port's logits and values
    on positions of random games equal flax's to 1e-5."""
    import json
    import pathlib

    from lightzero_tpu.models.alphazero import AlphaZeroModel as JaxAlphaZeroModel
    from lightzero_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
    from lightzero_tpu_torch.models import AlphaZeroModel
    from lightzero_tpu_torch.utils.params_import import flax_to_state_dict

    run = pathlib.Path(__file__).resolve().parent.parent / "data_az" / "go6_alphazero_resume_seed0"
    model_cfg = json.loads((run / "total_config.json").read_text())["policy"]["model"]
    model_cfg["observation_shape"] = tuple(model_cfg["observation_shape"])
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_load_checkpoint(str(run / "ckpt" / "params_best"))["params"])
    port = AlphaZeroModel.from_config(Config(model_cfg))
    port.load_state_dict(flax_to_state_dict(params))
    env = GoEnv(board_size=6, komi=4.5)
    g = torch.Generator().manual_seed(0)
    state, _ = env.reset(6, g)
    for _ in range(7):
        legal = env.legal_mask(state).float()
        state = env.step(state, torch.multinomial(legal, 1, generator=g)[:, 0], g).state
    obs = env.observation(state)
    exp_logits, exp_value = JaxAlphaZeroModel.from_config(model_cfg).apply(
        params, jnp.asarray(obs.numpy()))
    with torch.no_grad():
        logits, value = port(obs)
    np.testing.assert_allclose(logits.numpy(), np.asarray(exp_logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(exp_value), rtol=1e-5, atol=1e-5)
