"""The port stands alone and never falls back quietly:

- every module of lightzero_tpu_torch imports with jax, flax, optax and
  lightzero_tpu made unimportable, and no source of the port or
  chip_smoke.py names them (nor pytest) in an import; gymnasium and the
  host envs' libraries are imported only inside functions (where an adapter
  builds its env), so the host env modules import with those blocked too;
- with no CUDA device, the entry points built without ``device=`` raise
  (the multitask policies and entries among them);
- the kernel loader raises a clear error when nvcc is absent or fails, and
  never hands back the plain version; the replay core's loader raises when
  g++ is absent, and the buffer does not fall back to its Python path.
"""
import ast
import os
import pathlib
import stat
import subprocess
import sys

import pytest
import torch

from lightzero_tpu_torch import _build
from lightzero_tpu_torch.buffers import GameBuffer, native
from lightzero_tpu_torch.config import deep_merge
from lightzero_tpu_torch.envs import CartPoleEnv
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.search import RootOutput, SearchConfig, batch_puct_search
from lightzero_tpu_torch.search import check_fast_division
from lightzero_tpu_torch.search import fused_traverse as fused_traverse_module
from lightzero_tpu_torch.workers import Evaluator, RolloutCollector

pytestmark = pytest.mark.unittest

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "lightzero_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lightzero_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in {forbidden!r}:
    sys.modules[name] = None
import lightzero_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lightzero_tpu_torch.__path__, "lightzero_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules if m.split(".")[0] in {forbidden!r} and sys.modules[m] is not None]
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_without_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(forbidden=FORBIDDEN)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20  # modules walked


# the conv stack and the grid envs, named so that a rename cannot drop them
# from the walk above unnoticed
_IMPORT_NAMED = """
import importlib, sys
for name in {forbidden!r}:
    sys.modules[name] = None
for name in {modules!r}:
    importlib.import_module(name)
leaked = [m for m in sys.modules if m.split(".")[0] in {forbidden!r} and sys.modules[m] is not None]
assert not leaked, leaked
"""
GRID_AND_CONV_MODULES = (
    "lightzero_tpu_torch.envs.breakout_grid", "lightzero_tpu_torch.envs.minatar_like",
    "lightzero_tpu_torch.models.common", "lightzero_tpu_torch.configs.breakout_grid_muzero",
    "lightzero_tpu_torch.configs.space_invaders_grid_efficientzero",
)


def test_grid_envs_and_conv_stack_import_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_NAMED.format(forbidden=FORBIDDEN,
                                                    modules=GRID_AND_CONV_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr


# the bsuite and memory envs, the wrappers, the board games, the two-player
# search and AlphaZero, named as the grid modules are above
BOARD_AND_PROBE_MODULES = (
    "lightzero_tpu_torch.envs.bsuite_like", "lightzero_tpu_torch.envs.memory_env",
    "lightzero_tpu_torch.envs.wrappers", "lightzero_tpu_torch.envs.board.board_utils",
    "lightzero_tpu_torch.envs.board.tictactoe", "lightzero_tpu_torch.envs.board.connect4",
    "lightzero_tpu_torch.search.puct", "lightzero_tpu_torch.buffers.game_buffer",
    "lightzero_tpu_torch.models.alphazero", "lightzero_tpu_torch.policy.alphazero",
    "lightzero_tpu_torch.ops.board_augment", "lightzero_tpu_torch.workers.alphazero_workers",
    "lightzero_tpu_torch.entry.train_alphazero", "lightzero_tpu_torch.utils.params_import",
    "lightzero_tpu_torch.configs.catch_muzero", "lightzero_tpu_torch.configs.deep_sea_muzero",
    "lightzero_tpu_torch.configs.bsuite_efficientzero", "lightzero_tpu_torch.configs.memory_muzero",
    "lightzero_tpu_torch.configs.memory_efficientzero",
    "lightzero_tpu_torch.configs.tictactoe_muzero_bot_mode",
    "lightzero_tpu_torch.configs.tictactoe_muzero_sp_mode",
    "lightzero_tpu_torch.configs.tictactoe_efficientzero_bot_mode",
    "lightzero_tpu_torch.configs.connect4_muzero_bot_mode",
    "lightzero_tpu_torch.configs.connect4_muzero_ft",
    "lightzero_tpu_torch.configs.tictactoe_alphazero_bot_mode",
    "lightzero_tpu_torch.configs.tictactoe_alphazero_sp_mode",
    "lightzero_tpu_torch.configs.connect4_alphazero_bot_mode",
)


def test_board_games_probes_and_alphazero_import_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_NAMED.format(forbidden=FORBIDDEN,
                                                    modules=BOARD_AND_PROBE_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr


# Gomoku, Go and Chess, two-player Gumbel search, Gumbel and Sampled
# AlphaZero, and the board configs copied with them, named as above
BOARD_GAMES_AND_AZ_VARIANT_MODULES = (
    "lightzero_tpu_torch.envs.board.gomoku", "lightzero_tpu_torch.envs.board.go",
    "lightzero_tpu_torch.envs.board.chess", "lightzero_tpu_torch.search.gumbel",
    "lightzero_tpu_torch.policy.gumbel_alphazero", "lightzero_tpu_torch.policy.sampled_alphazero",
    "lightzero_tpu_torch.policy.gumbel_muzero", "lightzero_tpu_torch.entry.train_muzero",
    *(f"lightzero_tpu_torch.configs.{name}" for name in (
        "gomoku_alphazero_bot_mode", "gomoku_gumbel_alphazero", "gomoku_muzero_bot_mode",
        "gomoku_sampled_alphazero_bot_mode", "go6_alphazero_bot_mode", "go_alphazero_bot_mode",
        "go_alphazero_sp_mode", "go_muzero_bot_mode", "chess_alphazero_bot_mode",
        "chess_muzero_bot_mode", "tictactoe_gumbel_alphazero", "tictactoe_muzero_v2",
        "connect4_muzero_aug", "connect4_muzero_resume", "connect4_rezero_mz_bot_mode")),
)


def test_gomoku_go_chess_and_the_alphazero_variants_import_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_NAMED.format(forbidden=FORBIDDEN,
                                                    modules=BOARD_GAMES_AND_AZ_VARIANT_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr


# UniZero: the transformer world model, the MoE, the ViT, the model, both
# policies and their configs, named as above
UNIZERO_MODULES = (
    "lightzero_tpu_torch.models.unizero_world_model",
    "lightzero_tpu_torch.models.unizero_world_model.transformer",
    "lightzero_tpu_torch.models.unizero_world_model.moe", "lightzero_tpu_torch.models.vit",
    "lightzero_tpu_torch.models.unizero", "lightzero_tpu_torch.policy.unizero",
    "lightzero_tpu_torch.policy.sampled_unizero",
    *(f"lightzero_tpu_torch.configs.{name}" for name in (
        "cartpole_unizero", "breakout_grid_unizero", "breakout_grid_unizero_ws",
        "memory_unizero", "pendulum_sampled_unizero")),
)


def test_unizero_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_NAMED.format(forbidden=FORBIDDEN, modules=UNIZERO_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr


# multitask and scale-out: the multitask policies, their entries and
# configs, the benchmark tables and torch.distributed scale-out, named as above
MULTITASK_MODULES = (
    "lightzero_tpu_torch.policy.multitask", "lightzero_tpu_torch.entry.train_muzero_multitask",
    "lightzero_tpu_torch.entry.train_multitask_balance",
    "lightzero_tpu_torch.utils.benchmark_scores", "lightzero_tpu_torch.parallel",
    "lightzero_tpu_torch.parallel.distributed", "lightzero_tpu_torch.parallel.ddp",
    "lightzero_tpu_torch.parallel.dryrun",
    *(f"lightzero_tpu_torch.configs.{name}" for name in (
        "cartpole_pendulum_balance", "pendulum_suite_scalezero", "pendulum_suite_scalezero_v2",
        "pendulum_suite_scalezero_v3")),
)


def test_multitask_and_scale_out_import_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_NAMED.format(forbidden=FORBIDDEN,
                                                    modules=MULTITASK_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr


# the host envs' libraries: imported where an adapter builds its env, never
# when a module is imported
HOST_LIBRARIES = ("gymnasium", "gym", "dm_control", "mujoco", "Box2D", "ale_py", "minigrid",
                  "jericho", "metadrive", "pooltool", "transformers")
# the host envs and collector, RND, eval_offline and their configs, named as
# above, imported with the host libraries blocked too
HOST_AND_RND_MODULES = (
    "lightzero_tpu_torch.envs.host_env", "lightzero_tpu_torch.envs.dmc2gym_env",
    "lightzero_tpu_torch.envs.atari", "lightzero_tpu_torch.envs.minigrid_env",
    "lightzero_tpu_torch.envs.jericho_env", "lightzero_tpu_torch.envs.metadrive_env",
    "lightzero_tpu_torch.envs.pooltool_env", "lightzero_tpu_torch.workers.host_collector",
    "lightzero_tpu_torch.reward_model", "lightzero_tpu_torch.reward_model.rnd",
    "lightzero_tpu_torch.entry.train_muzero_with_reward_model",
    "lightzero_tpu_torch.entry.eval_offline", "lightzero_tpu_torch.entry",
    *(f"lightzero_tpu_torch.configs.{name}" for name in (
        "lunarlander_disc_muzero", "lunarlander_cont_sampled_efficientzero",
        "bipedalwalker_cont_sampled_muzero", "mtcar_muzero", "mujoco_sampled_efficientzero",
        "dmc2gym_state_smz", "dmc2gym_pixels_sez", "memory_muzero_rnd", "pendulum_disc_muzero",
        "cartpole_stochastic_muzero", "stochastic_muzero_2048_v2", "memory250_unizero",
        "breakout_grid_unizero_v9")),
)


def test_host_envs_rnd_and_eval_offline_import_without_jax_or_the_host_libraries():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_NAMED.format(forbidden=FORBIDDEN + HOST_LIBRARIES,
                                                    modules=HOST_AND_RND_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr


# the rest of the JAX package (slice 21): the Agent API, the loss landscape,
# LPIPS, the analysis, visualisation and text-encoder modules, augment,
# profiling, the logger and the gated configs, named as above, imported with
# the host libraries, matplotlib and tensorboard blocked too
REST_MODULES = (
    "lightzero_tpu_torch.agent", "lightzero_tpu_torch.agent.agent",
    "lightzero_tpu_torch.agent.configs", "lightzero_tpu_torch.loss_landscape",
    "lightzero_tpu_torch.loss_landscape.core", "lightzero_tpu_torch.loss_landscape.plots",
    "lightzero_tpu_torch.ops.lpips", "lightzero_tpu_torch.ops.augment",
    "lightzero_tpu_torch.models.analysis", "lightzero_tpu_torch.models.visualize",
    "lightzero_tpu_torch.models.text_encoders", "lightzero_tpu_torch.utils.profiling",
    "lightzero_tpu_torch.utils.logger", "lightzero_tpu_torch.workers.evaluator",
    *(f"lightzero_tpu_torch.configs.{name}" for name in (
        "atari_muzero", "atari_unizero_moe", "minigrid_muzero_rnd", "jericho_unizero",
        "metadrive_sampled_efficientzero", "sum_to_three_vector_obs_sez")),
)


def test_the_rest_of_the_jax_package_imports_without_jax_or_optional_libraries():
    blocked = FORBIDDEN + HOST_LIBRARIES + ("matplotlib", "tensorboard", "wandb", "sklearn")
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_NAMED.format(forbidden=blocked, modules=REST_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr


def _imported_roots(path: pathlib.Path, module_level: bool = False):
    """The top-level package of each import of ``path``; with
    ``module_level``, of the imports that run when the module is imported
    (not those inside a function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = ast.walk(tree)
    if module_level:
        def outside_functions(node):
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    yield from outside_functions(child)

        nodes = outside_functions(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    [REPO / "chip_smoke.py", *sorted(PACKAGE.rglob("*.py"))],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_source_imports_jax_or_test_only_packages(path):
    bad = set(_imported_roots(path)) & set(FORBIDDEN + ("pytest",))
    assert not bad, f"{path} imports {bad}"
    eager = set(_imported_roots(path, module_level=True)) & set(HOST_LIBRARIES)
    assert not eager, f"{path} imports {eager} when it is imported"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_policy_without_device_raises_with_no_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MuZeroPolicy()


def test_evaluator_without_device_raises_with_no_cuda(no_cuda):
    policy = MuZeroPolicy(dict(num_simulations=2), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(CartPoleEnv(), policy)


def test_collector_without_device_raises_with_no_cuda(no_cuda):
    policy = MuZeroPolicy(dict(num_simulations=2), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RolloutCollector(CartPoleEnv(), policy, num_envs=2)


def test_search_without_device_raises_with_no_cuda(no_cuda):
    root = RootOutput(prior_logits=torch.zeros(2, 3), value=torch.zeros(2),
                      embedding=torch.zeros(2, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_puct_search(root, None, SearchConfig(num_simulations=2),
                          torch.ones(2, 3, dtype=torch.bool))


def test_unizero_policies_without_device_raise_with_no_cuda(no_cuda):
    from lightzero_tpu_torch.policy import SampledUniZeroPolicy, UniZeroPolicy

    for cls in (UniZeroPolicy, SampledUniZeroPolicy):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(dict(model=dict(embed_dim=16, num_heads=2), num_simulations=2))


def test_multitask_policies_and_entries_without_device_raise_with_no_cuda(no_cuda, tmp_path):
    import copy

    from lightzero_tpu_torch.configs.pendulum_suite_scalezero_v3 import task_configs
    from lightzero_tpu_torch.entry import train_multitask_balance, train_muzero_multitask
    from lightzero_tpu_torch.policy import MuZeroMTPolicy, SampledUniZeroMTPolicy, UniZeroMTPolicy

    for cls in (MuZeroMTPolicy, UniZeroMTPolicy, SampledUniZeroMTPolicy):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(dict(model=dict(embed_dim=16, num_heads=2, latent_state_dim=8),
                     num_simulations=2))
    cfgs = copy.deepcopy(task_configs)
    for c in cfgs:
        c.exp_name = str(tmp_path / "exp")
    for entry in (train_muzero_multitask, train_multitask_balance):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(cfgs)


def test_host_workers_rnd_and_their_entries_without_device_raise_with_no_cuda(no_cuda, tmp_path):
    import copy

    from lightzero_tpu_torch.configs.memory_muzero_rnd import main_config
    from lightzero_tpu_torch.entry import eval_offline, train_muzero_with_reward_model
    from lightzero_tpu_torch.reward_model import RNDRewardModel
    from lightzero_tpu_torch.workers import HostCollector, HostEvaluator

    class Env:
        num_envs = 2

    policy = MuZeroPolicy(dict(num_simulations=2), device="cpu")
    for cls in (HostCollector, HostEvaluator):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(Env(), policy)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RNDRewardModel(8)
    cfg = copy.deepcopy(main_config)
    cfg.exp_name = str(tmp_path / "exp")
    for fn in (train_muzero_with_reward_model, eval_offline):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(cfg)


def test_agent_and_lpips_without_device_raise_with_no_cuda(no_cuda):
    from lightzero_tpu_torch.agent import AlphaZeroAgent, MuZeroAgent, UniZeroAgent
    from lightzero_tpu_torch.ops.lpips import LPIPS

    for cls, env_id in ((MuZeroAgent, "gym_cartpole_v0"), (UniZeroAgent, "gym_cartpole_v0"),
                        (AlphaZeroAgent, "tictactoe_play_with_bot")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(env_id)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LPIPS()


def test_alphazero_policy_without_device_raises_with_no_cuda(no_cuda):
    from lightzero_tpu_torch.envs import TicTacToeEnv
    from lightzero_tpu_torch.policy import AlphaZeroPolicy

    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlphaZeroPolicy(None, TicTacToeEnv())


@pytest.mark.parametrize("name", ["GumbelAlphaZeroPolicy", "SampledAlphaZeroPolicy"])
def test_alphazero_variants_without_device_raise_with_no_cuda(no_cuda, name):
    import lightzero_tpu_torch.policy as policies
    from lightzero_tpu_torch.envs import GomokuEnv

    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(policies, name)(None, GomokuEnv())


def test_division_check_exits_nonzero_with_no_cuda(no_cuda, capsys):
    assert check_fast_division.main() == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_entries", {})
    return tmp_path


def test_loader_raises_when_nvcc_is_absent(no_nvcc):
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.load("fused_traverse")
    # an entry point's binding raises too: no plain version comes back
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.entry("fused_traverse_launch")
    assert not (no_nvcc / "build").exists()


def test_kernel_route_raises_when_nvcc_is_absent(no_nvcc):
    # the route is the built kernel's answer; nothing guesses it without one
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        fused_traverse_module.kernel_route(4)


def test_loader_raises_with_the_compiler_output_when_nvcc_fails(no_nvcc):
    bindir = no_nvcc / "empty"
    bindir.mkdir()
    fake = bindir / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fused_traverse.cu(1): error: made-up failure' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    with pytest.raises(_build.BuildError, match="made-up failure"):
        _build.load("fused_traverse")
    assert not list((no_nvcc / "build").glob("*.so"))


def test_replay_core_raises_when_gxx_is_absent(no_nvcc):
    with pytest.raises(_build.BuildError, match=r"g\+\+ not found"):
        native.library()
    policy = MuZeroPolicy(dict(num_simulations=2, model=dict(latent_state_dim=8)), device="cpu")
    with pytest.raises(_build.BuildError, match=r"g\+\+ not found"):
        GameBuffer(policy.cfg, policy)
    # the Python path runs only when the config asks for it
    buf = GameBuffer(deep_merge(policy.cfg, dict(use_native_replay=False)), policy)
    assert not buf._use_native
    assert not (no_nvcc / "build").exists()
