"""Training entry (``lightzero_tpu/entry/train_muzero.py``) for the ported
policies: MuZero, EfficientZero, Gumbel MuZero, Stochastic MuZero, Sampled
MuZero, Sampled EfficientZero, MuZero-Context, MuZero-RNN-full-obs, UniZero
and Sampled UniZero,
chosen by ``cfg.policy.type`` from ``POLICIES`` as the JAX entry does from
its registry, on the ported envs (CartPole, 2048, Pendulum, the five
MinAtar-class grids: breakout, asterix, freeway, space invaders, seaquest,
the bsuite probes deep_sea and catch, the memory env, and the board games
tictactoe, connect4, gomoku, go and chess, whose ``battle_mode`` the env
config sets), chosen by ``cfg.env.env_id`` (or ``cfg.env.type``). On board
games (``env_type`` "board_games") it runs the policy types that the JAX
entry runs there, ``BOARD_POLICIES``; the others fail in the JAX package and
are refused with a ``ValueError`` that names the failure (ROADMAP queue 3).

Loop: [eval every ``eval_freq`` train iterations, stopping after
``stop_consecutive_evals`` evals at ``stop_value``] -> collect (episode mode,
or segment mode with ``num_segments``) -> push to the buffer -> [ReZero's
whole-buffer reanalyze with the target net, every ``1 / buffer_reanalyze_freq``
collect rounds] -> ``update_per_collect`` (or replay-ratio) learn steps, each on a fresh
prioritized sample, once the buffer holds a batch and
``train_start_after_envsteps`` env steps are done -> until ``max_env_step``
or ``max_train_iter``. A non-finite loss saves ``ckpt/ckpt_nan`` and raises;
checkpoints are written every ``save_ckpt_freq`` iterations with
``ckpt/resume_meta.json``, which ``auto_resume`` reads; ``ckpt_best`` and
``params_best`` on a new best eval, ``ckpt_final`` at the end.

Usage (on the card, or with ``device="cpu"``)::

    from lightzero_tpu_torch.configs.cartpole_muzero import main_config
    from lightzero_tpu_torch.entry import train_muzero
    policy, state, stats = train_muzero(main_config, seed=0, max_env_step=100_000)

``eval_muzero`` loads a checkpoint (or params export) and runs the
deterministic eval.

An env id that ``ENVS`` does not hold is a host env (``create_env``
gives None): ``make_host_vec_env`` builds it as the JAX entry does
(train_muzero.py:85-120), gymnasium's ids through ``HostVecEnv`` and the
other families through their adapters, and the loop collects and evaluates
through ``HostCollector`` and ``HostEvaluator`` (the evaluator's envs seeded
from ``seed + 777``). The ids on which the JAX package fails
(``JAX_HOST_ENV_FAULTS``: ``lunarlander``, which gymnasium does not know)
are refused with a ``ValueError`` that quotes the failure.
``eval_muzero`` evaluates tensor envs only: on a host env the JAX
``eval_muzero`` hands create_env's None to its ``Evaluator`` and fails
(``JAX_HOST_EVAL_FAULT``), and the port refuses it with a ``ValueError``.

The multitask policy types are refused with a ``ValueError``: they train
through ``train_muzero_multitask`` and ``train_multitask_balance``, and fail
in the JAX package's ``train_muzero`` (``JAX_MULTITASK_FAULT``). So is a
config with ``reward_model``: it trains through
``train_muzero_with_reward_model``, where the JAX ``train_muzero`` trains
without the reward model's bonus and says nothing (``JAX_REWARD_MODEL_QUIRK``).

With ``policy.analysis_loss_landscape`` the run ends with the loss
landscape around the trained params (``loss_landscape_api`` on one batch
sampled with the target model, ``policy.loss_landscape_mode``, "1d" by
default) under ``<exp_name>/loss_landscape``, as the JAX entry does
(train_muzero.py:346-357); ``entry.train_unizero_with_loss_landscape``
sets the flag.
"""
from __future__ import annotations

import inspect
import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from lightzero_tpu_torch.buffers import GameBuffer
from lightzero_tpu_torch.config import Config, compile_config, deep_merge
from lightzero_tpu_torch.entry.utils import calculate_update_per_collect, random_collect, safe_eval
from lightzero_tpu_torch.models.common import conv_latent_shape
from lightzero_tpu_torch.envs import (
    AsterixGridEnv,
    BreakoutGridEnv,
    CartPoleEnv,
    CatchEnv,
    ChessEnv,
    Connect4Env,
    DeepSeaEnv,
    FreewayGridEnv,
    Game2048Env,
    GoEnv,
    GomokuEnv,
    MemoryEnv,
    PendulumEnv,
    SeaquestGridEnv,
    SpaceInvadersGridEnv,
    TensorEnv,
    TicTacToeEnv,
)
from lightzero_tpu_torch.ops import visit_count_temperature
from lightzero_tpu_torch.policy import (
    EfficientZeroPolicy,
    GumbelMuZeroPolicy,
    MuZeroContextPolicy,
    MuZeroPolicy,
    MuZeroRNNFullObsPolicy,
    SampledEfficientZeroPolicy,
    SampledMuZeroPolicy,
    SampledUniZeroPolicy,
    StochasticMuZeroPolicy,
    UniZeroPolicy,
)
from lightzero_tpu_torch.utils.checkpoint import (
    load_checkpoint_lenient,
    save_checkpoint,
    save_params_export,
)
from lightzero_tpu_torch.utils.device import resolve_device
from lightzero_tpu_torch.utils.logger import ExperimentLogger
from lightzero_tpu_torch.workers import Evaluator, HostCollector, HostEvaluator, RolloutCollector

# env_id -> (env class, constructor arguments), as the JAX entry's aliases
# and registry resolve them
ENVS = {
    "CartPole-v0": (CartPoleEnv, {}),
    "CartPole-v1": (CartPoleEnv, {"max_episode_steps": 500}),
    "cartpole": (CartPoleEnv, {}),
    "game_2048": (Game2048Env, {}),
    "Pendulum-v1": (PendulumEnv, {}),
    "pendulum": (PendulumEnv, {}),
    "breakout_grid": (BreakoutGridEnv, {}),
    "asterix_grid": (AsterixGridEnv, {}),
    "freeway_grid": (FreewayGridEnv, {}),
    "space_invaders_grid": (SpaceInvadersGridEnv, {}),
    "seaquest_grid": (SeaquestGridEnv, {}),
    "deep_sea": (DeepSeaEnv, {}),
    "catch": (CatchEnv, {}),
    "memory": (MemoryEnv, {}),
    "tictactoe": (TicTacToeEnv, {}),
    "connect4": (Connect4Env, {}),
    "gomoku": (GomokuEnv, {}),
    "go": (GoEnv, {}),
    "chess": (ChessEnv, {}),
}
# cfg.policy.type -> the policy that train_muzero builds
POLICIES = {
    "muzero": MuZeroPolicy, "efficientzero": EfficientZeroPolicy,
    "gumbel_muzero": GumbelMuZeroPolicy, "stochastic_muzero": StochasticMuZeroPolicy,
    "sampled_muzero": SampledMuZeroPolicy, "sampled_efficientzero": SampledEfficientZeroPolicy,
    "muzero_context": MuZeroContextPolicy, "muzero_rnn_full_obs": MuZeroRNNFullObsPolicy,
    "unizero": UniZeroPolicy, "sampled_unizero": SampledUniZeroPolicy,
}
# the policies that train_muzero runs on board games (env_type "board_games"):
# those that the JAX entry runs there
BOARD_POLICIES = ("muzero", "efficientzero", "gumbel_muzero", "muzero_context", "unizero",
                  "sampled_unizero")
# the other policy types, each with the way the JAX entry fails on a board
# game (a TicTacToe bot-mode config through lightzero_tpu's train_muzero)
JAX_BOARD_FAULTS = {
    "stochastic_muzero": "the JAX policy flattens the board planes before its conv "
                         "representation network and raises flax's ScopeParamShapeError",
    "sampled_muzero": "the JAX policy's actions are float arrays, with which the board env's "
                      "step_single cannot index its board: JAX raises TypeError",
    "sampled_efficientzero": "the JAX policy's actions are float arrays, with which the board "
                             "env's step_single cannot index its board: JAX raises TypeError",
    "muzero_rnn_full_obs": "the JAX MuZero-RNN model calls int() on the board's observation "
                           "shape and raises TypeError",
}
# the multitask policy types train only through the multitask entries: in
# the JAX package's train_muzero their first learn step fails, since only
# the multitask entries attach the task fields to the batch
MULTITASK_POLICIES = ("muzero_multitask", "unizero_multitask", "sampled_unizero_multitask")
JAX_MULTITASK_FAULT = (
    "the JAX package's train_muzero raises AttributeError: 'TrainBatch' object has no "
    "attribute 'task_id' at the first learn step (lightzero_tpu/policy/multitask.py:75-78 reads "
    "the task fields, which only the multitask entries attach); train it with "
    "train_muzero_multitask or train_multitask_balance (ROADMAP queue 3)")


# host env ids on which the JAX package fails, with the failure: the
# zoo's two lunarlander configs set env=dict(type="lunarlander") and no
# env_id, which the JAX entry hands to gymnasium.make (ROADMAP queue 3)
JAX_HOST_ENV_FAULTS = {
    "lunarlander": "the JAX entry hands the id to gymnasium.make, which raises "
                   "gymnasium.error.NameNotFound: Environment `lunarlander` doesn't exist. "
                   "(set env_id='LunarLander-v3')",
}
# how the JAX entries that build their workers from create_env alone fail
# on a host env: create_env gives None, which their workers reset
JAX_HOST_EVAL_FAULT = (
    "the JAX package's entry builds its workers on create_env's None for a host env, and they "
    "raise AttributeError: 'NoneType' object has no attribute 'reset' (ROADMAP queue 3)")
JAX_REWARD_MODEL_QUIRK = (
    "the JAX package's train_muzero ignores cfg.reward_model without a word and trains "
    "without the intrinsic bonus (ROADMAP queue 3); train it with "
    "train_muzero_with_reward_model")


def env_id_of(env_cfg: Config) -> str:
    return env_cfg.get("env_id", env_cfg.get("type"))


def create_env(env_cfg: Config) -> Optional[TensorEnv]:
    """The tensor env of ``env_cfg.env_id``, with the env-config keys that
    match its constructor's arguments (``max_episode_steps``, ``discrete_bins``, ...)
    and ``env_kwargs`` forwarded, as the JAX entry does (train_muzero.py:61-82);
    None for an id that ``ENVS`` does not hold, a host env
    (``make_host_vec_env``)."""
    env_id = env_id_of(env_cfg)
    if env_id not in ENVS:
        return None
    env_cls, kwargs = ENVS[env_id]
    kwargs = dict(kwargs)
    params = inspect.signature(env_cls.__init__).parameters
    kwargs.update({k: v for k, v in dict(env_cfg).items() if k in params and k != "self"})
    kwargs.update(env_cfg.get("env_kwargs", {}))
    return env_cls(**kwargs)


def tensor_env(env_cfg: Config, entry: str) -> TensorEnv:
    """``create_env``, for the entries that run tensor envs only: a
    ``ValueError`` on a host env, where the JAX entry fails."""
    env = create_env(env_cfg)
    if env is None:
        raise ValueError(f"{entry} runs the tensor envs of ENVS only, and "
                         f"{env_id_of(env_cfg)!r} is a host env: {JAX_HOST_EVAL_FAULT}")
    return env


def make_host_vec_env(env_cfg: Config, num_envs: int, seed: int):
    """The host env of ``env_cfg`` with ``num_envs`` envs, seeded from
    ``seed``, by family as the JAX entry dispatches (train_muzero.py:85-120):
    ``ALE/*`` -> ``AtariVecEnv``, ``MiniGrid-*`` or ``minigrid`` ->
    ``MiniGridVecEnv``, ``jericho`` -> ``JerichoVecEnv``, ``dmc2gym`` ->
    ``DMC2GymVecEnv``, ``metadrive`` -> ``MetaDriveVecEnv``, ``pooltool`` or
    ``sum_to_three`` -> ``SumToThreeVecEnv``, any other id -> gymnasium's
    ``HostVecEnv`` (Box2D, MuJoCo, MountainCar). ``env_kwargs`` go to the
    adapter. The ids of ``JAX_HOST_ENV_FAULTS`` raise ``ValueError``."""
    env_id = str(env_id_of(env_cfg) or "")
    if env_id in JAX_HOST_ENV_FAULTS:
        raise ValueError(f"host env {env_id!r}: {JAX_HOST_ENV_FAULTS[env_id]} (ROADMAP queue 3)")
    kwargs = dict(env_cfg.get("env_kwargs", {}))
    if env_id.startswith("ALE/"):
        from lightzero_tpu_torch.envs.atari import AtariVecEnv

        return AtariVecEnv(env_id, num_envs, seed=seed, env_kwargs=kwargs or None)
    if env_id.startswith("MiniGrid-") or env_id == "minigrid":
        from lightzero_tpu_torch.envs.minigrid_env import MiniGridVecEnv

        mg_id = kwargs.pop("env_id", env_id if env_id != "minigrid" else "MiniGrid-Empty-8x8-v0")
        return MiniGridVecEnv(mg_id, num_envs, seed=seed, **kwargs)
    if env_id == "jericho":
        from lightzero_tpu_torch.envs.jericho_env import JerichoVecEnv

        return JerichoVecEnv(num_envs=num_envs, seed=seed, **kwargs)
    if env_id == "dmc2gym":
        from lightzero_tpu_torch.envs.dmc2gym_env import DMC2GymVecEnv

        return DMC2GymVecEnv(num_envs=num_envs, seed=seed, **kwargs)
    if env_id == "metadrive":
        from lightzero_tpu_torch.envs.metadrive_env import MetaDriveVecEnv

        return MetaDriveVecEnv(num_envs=num_envs, seed=seed, **kwargs)
    if env_id in ("pooltool", "sum_to_three"):
        from lightzero_tpu_torch.envs.pooltool_env import SumToThreeVecEnv

        return SumToThreeVecEnv(num_envs=num_envs, seed=seed, **kwargs)
    from lightzero_tpu_torch.envs.host_env import HostVecEnv

    return HostVecEnv(env_id, num_envs, seed=seed, env_kwargs=kwargs or None)


def check_observation_shape(env, pcfg: Config, policy_cls) -> None:
    """Raise ``ValueError`` where the env's observations do not fit the
    model of ``pcfg.model``: a conv model reads them as they are, an MLP
    model as a flat vector, flattened first only by a policy with
    ``flattens_observations`` (Stochastic MuZero). The zoo's plain MuZero
    2048 configs set an MLP over 256 inputs on (4, 4, 16) planes, which the
    JAX package takes as they are and fails on (ROADMAP queue 3). A conv
    model whose downsampling leaves no cell (a 3x3 board with the default
    ``downsample``, as two zoo TicTacToe configs set it) is refused too: the
    JAX package fails on it while it builds the model."""
    model = pcfg.model
    env_shape = tuple(np.atleast_1d(env.observation_shape).tolist())
    model_shape = tuple(np.atleast_1d(model.get("observation_shape", 4)).tolist())
    if getattr(policy_cls, "flattens_observations", False):
        fits = int(np.prod(env_shape)) == int(np.prod(model_shape))
    else:
        fits = env_shape == model_shape
    if fits and model.get("model_type", "mlp") == "conv":
        h, w, _ = conv_latent_shape(model_shape, 1, bool(model.get("downsample", True)))
        if h * w == 0:
            raise ValueError(
                f"the conv model of cfg.policy.model downsamples observations of shape "
                f"{model_shape} to nothing: set downsample=False (the JAX package fails on such "
                "configs too, e.g. zoo/board_games/tictactoe/config/"
                "tictactoe_muzero_sp_mode_config.py: ROADMAP queue 3)"
            )
    if not fits:
        kind = model.get("model_type", "mlp")
        raise ValueError(
            f"the {kind} model of cfg.policy.model reads observations of shape {model_shape}, "
            f"but the env {type(env).__name__} gives {env_shape}, and the "
            f"{pcfg.get('type', 'muzero')} policy does not flatten them (the JAX package fails "
            "on such configs too, e.g. zoo/game_2048/config/muzero_2048_config.py: ROADMAP "
            "queue 3)"
        )


def _check_scope(pcfg: Config) -> None:
    policy_type = pcfg.get("type", "muzero")
    if policy_type in MULTITASK_POLICIES:
        raise ValueError(f"train_muzero does not train the {policy_type} policy: "
                         f"{JAX_MULTITASK_FAULT}")
    if policy_type not in POLICIES:
        raise NotImplementedError(f"policy type {policy_type!r} is not ported (ROADMAP queue 1)")
    if pcfg.get("env_type") == "board_games" and policy_type not in BOARD_POLICIES:
        raise ValueError(
            f"the {policy_type} policy does not run on board games: "
            f"{JAX_BOARD_FAULTS[policy_type]} (ROADMAP queue 3)")


def train_muzero(
    cfg,
    seed: int = 0,
    model_path: Optional[str] = None,
    max_env_step: int = int(1e6),
    max_train_iter: int = int(1e9),
    device: Optional[Union[str, torch.device]] = None,
):
    """Train the policy that ``cfg.policy.type`` names on ``cfg``
    (``{"env": ..., "policy": ...}``, or ``[main_config, create_config]``).
    Runs on ``device``: ``cuda`` unless the caller names another. ``model_path`` warm-starts from a checkpoint
    or params export.

    Returns ``(policy, state, stats)``: ``stats`` holds ``env_steps``,
    ``train_iter``, ``best_return``, ``eval_env_steps`` (the evaluator's
    batched steps over all evals) and ``buffer``, the replay buffer."""
    if isinstance(cfg, (list, tuple)):
        cfg = cfg[0]
    dev = resolve_device(device)
    pcfg = Config(Config(cfg).get("policy", {}))
    _check_scope(pcfg)
    if Config(cfg).get("reward_model", None):
        raise ValueError(f"train_muzero does not take cfg.reward_model: {JAX_REWARD_MODEL_QUIRK}")
    policy_cls = POLICIES[pcfg.get("type", "muzero")]
    cfg = compile_config(cfg, policy_cls.default_config(), seed)
    pcfg = cfg.policy
    pcfg.seed = seed

    n_collect_envs = cfg.env.get("collector_env_num", 8)
    n_eval_envs = cfg.env.get("evaluator_env_num", 3)
    env = create_env(cfg.env)
    if env is None:
        # a host env: its collect and eval envs are built before the policy,
        # so that an absent library or a failing id stops the run first
        collect_envs = make_host_vec_env(cfg.env, n_collect_envs, seed)
        eval_envs = make_host_vec_env(cfg.env, n_eval_envs, seed + 777)
    check_observation_shape(env or collect_envs, pcfg, policy_cls)
    policy = policy_cls(pcfg, device=dev, seed=seed)
    state = policy.init_train_state()
    if model_path:
        state = load_checkpoint_lenient(model_path, target=state)

    buffer = GameBuffer(pcfg, policy)
    if env is not None:
        collector = RolloutCollector(env, policy, n_collect_envs, seed=seed + 1, device=dev)
        evaluator = Evaluator(env, policy, n_eval_envs, seed=seed + 2, device=dev)
    else:
        collector = HostCollector(collect_envs, policy, device=dev)
        evaluator = HostEvaluator(eval_envs, policy, device=dev)
    logger = ExperimentLogger(cfg.exp_name, "train")
    ckpt_dir = os.path.join(cfg.exp_name, "ckpt")
    stop_value = cfg.env.get("stop_value", float("inf"))
    stop_streak = 0
    eval_freq = int(pcfg.get("eval_freq", 100))
    batch_size = int(pcfg.batch_size)
    n_episode = int(pcfg.get("n_episode", 8))
    last_eval_iter = -eval_freq - 1
    eval_env_steps = 0

    train_iter = 0
    # auto-resume: restore the last periodic checkpoint and the counters of
    # this exp dir; the buffer is refilled by fresh self-play
    if not model_path and pcfg.get("auto_resume", False):
        meta_path = os.path.join(ckpt_dir, "resume_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            state = load_checkpoint_lenient(os.path.join(ckpt_dir, meta["last_ckpt"]), target=state)
            train_iter = int(meta["train_iter"])
            collector.total_env_steps = int(meta["env_steps"])
            logger.info(
                f"auto_resume: restored {meta['last_ckpt']} "
                f"(iter={train_iter} envstep={collector.total_env_steps})"
            )
    logger.info(
        f"train_muzero: exp={cfg.exp_name} device={dev} max_env_step={max_env_step} "
        f"sims={pcfg.num_simulations} batch={batch_size}"
    )
    n_warmup = int(pcfg.get("random_collect_episode_num", 0))
    if n_warmup > 0:
        wstats = random_collect(collector, buffer, num_episodes=n_warmup)
        logger.info(f"random_collect: {wstats['episodes']} episodes, {wstats['steps']} steps")
    while collector.total_env_steps < max_env_step and train_iter < max_train_iter:
        temperature = visit_count_temperature(
            pcfg.get("manual_temperature_decay", False),
            pcfg.get("fixed_temperature_value", 0.25),
            pcfg.get("threshold_training_steps_for_final_temperature", int(1e5)),
            train_iter,
        )
        # ---- eval ----
        if train_iter - last_eval_iter >= eval_freq:
            last_eval_iter = train_iter
            res = safe_eval(
                evaluator,
                n_episodes=cfg.env.get("n_evaluator_episode", n_eval_envs),
                timeout_s=float(pcfg.get("eval_timeout_s", 1800.0)),
            )
            if res is None:
                logger.info("safe_eval: evaluation timed out; continuing training")
                continue
            eval_env_steps += res["env_steps"]
            logger.log_scalars(
                {"eval_mean_return": res["mean_return"], "eval_max_return": res["max_return"]},
                collector.total_env_steps,
                prefix="evaluator/",
            )
            logger.info(
                f"iter={train_iter} envstep={collector.total_env_steps} "
                f"EVAL mean_return={res['mean_return']:.1f}"
            )
            if res["new_best"]:
                save_checkpoint(state, os.path.join(ckpt_dir, "ckpt_best"))
                save_params_export(state, os.path.join(ckpt_dir, "params_best"))
            # stop only after N consecutive evals at or above stop_value
            if res["mean_return"] >= stop_value:
                stop_streak += 1
                if stop_streak >= int(pcfg.get("stop_consecutive_evals", 1)):
                    logger.info(f"stop_value {stop_value} reached; stopping.")
                    break
            else:
                stop_streak = 0
        # ---- collect ----
        num_segments = pcfg.get("num_segments", None)
        if num_segments:
            episodes, priorities, cstats = collector.collect(
                temperature=temperature,
                epsilon=pcfg.get("collect_epsilon", 0.0),
                min_steps=int(num_segments) * int(pcfg.get("game_segment_length", 200)),
            )
        else:
            episodes, priorities, cstats = collector.collect(
                temperature=temperature,
                epsilon=pcfg.get("collect_epsilon", 0.0),
                num_episodes=n_episode,
            )
        buffer.push_episodes(episodes, priorities)
        # ReZero's periodic whole-buffer reanalyze (train_muzero.py:274-289)
        br_freq = float(pcfg.get("buffer_reanalyze_freq", 0.0))
        if br_freq > 0:
            collect_round = collector.total_episodes // max(n_episode, 1)
            every = max(1, int(round(1.0 / br_freq)))
            if collect_round % every == 0 and buffer.num_transitions > 0:
                n_re = buffer.reanalyze_buffer(
                    state.target_model,
                    reanalyze_batch_size=int(pcfg.get("reanalyze_batch_size", 256)),
                    partition=float(pcfg.get("reanalyze_partition", 0.75)),
                    reuse_search=bool(pcfg.get("reuse_search", False)),
                )
                logger.info(f"rezero: reanalyzed {n_re} transitions")
        logger.log_scalars(
            {
                "collect_mean_return": cstats["mean_return"],
                "steps_per_sec": cstats["steps_per_sec"],
                "buffer_transitions": buffer.num_transitions,
                "temperature": temperature,
                # the search's telemetry where the collector gives it (the
                # host collector does not, as in JAX)
                **{k: v for k, v in cstats.items()
                   if k in ("visit_mean_action", "collect_mu", "collect_sigma",
                            "visit_entropy", "searched_value")},
            },
            collector.total_env_steps,
            prefix="collector/",
        )
        # ---- train ----
        upc = calculate_update_per_collect(pcfg, cstats["steps"])
        if buffer.num_transitions < batch_size:
            continue
        if collector.total_env_steps < int(pcfg.get("train_start_after_envsteps", 0)):
            continue
        logs: Dict = {}
        for _ in range(upc):
            batch, idx = buffer.sample(batch_size, state.target_model)
            state, logs, priority = policy.forward_learn(state, batch)
            buffer.update_priority(idx, priority.cpu().numpy())
            train_iter += 1
        # numerical guard: a non-finite loss stops the run with its state
        if logs and not np.isfinite(float(logs["total_loss"])):
            save_checkpoint(state, os.path.join(ckpt_dir, "ckpt_nan"))
            logger.close()
            raise RuntimeError(
                f"non-finite total_loss={float(logs['total_loss'])} at iter {train_iter} "
                f"(state saved to ckpt/ckpt_nan)"
            )
        logger.log_scalars(logs, collector.total_env_steps, prefix="learner/")
        logger.info(
            f"iter={train_iter} envstep={collector.total_env_steps} "
            f"loss={float(logs.get('total_loss', 0)):.3f} "
            f"collect_return={cstats['mean_return']:.1f} "
            f"sps={cstats['steps_per_sec']:.0f}"
        )
        if train_iter % int(pcfg.get("save_ckpt_freq", 10_000)) < upc:
            name = f"iteration_{train_iter}"
            save_checkpoint(state, os.path.join(ckpt_dir, name))
            with open(os.path.join(ckpt_dir, "resume_meta.json"), "w") as f:
                json.dump(dict(last_ckpt=name, train_iter=train_iter,
                               env_steps=int(collector.total_env_steps)), f)

    # post-training loss-landscape analysis (reference
    # train_unizero_with_loss_landscape's final phase)
    if pcfg.get("analysis_loss_landscape", False) and buffer.num_transitions >= batch_size:
        from lightzero_tpu_torch.loss_landscape import loss_landscape_api

        batch, _ = buffer.sample(batch_size, state.target_model)
        loss_landscape_api(policy, state.model, batch,
                           os.path.join(cfg.exp_name, "loss_landscape"),
                           mode=str(pcfg.get("loss_landscape_mode", "1d")))
        logger.info(f"loss_landscape: surface saved under {cfg.exp_name}/loss_landscape")
    save_checkpoint(state, os.path.join(ckpt_dir, "ckpt_final"))
    logger.close()
    return policy, state, dict(
        env_steps=collector.total_env_steps,
        train_iter=train_iter,
        best_return=evaluator.best_return,
        eval_env_steps=eval_env_steps,
        buffer=buffer,
    )


def eval_muzero(
    cfg,
    seed: int = 0,
    model_path: Optional[str] = None,
    n_episodes: int = 5,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict:
    """Load a checkpoint or params export (``model_path``; random weights from
    ``seed`` without one) into the policy that ``cfg.policy.type`` names and
    run the deterministic eval on ``cfg.env.evaluator_env_num`` envs until
    ``n_episodes`` episodes have ended (``entry/train_muzero.py:367``). Runs
    on ``device``: ``cuda`` unless the caller names another. Writes nothing.
    Returns the ``Evaluator.eval`` record. A host env raises ``ValueError``,
    where the JAX ``eval_muzero`` fails (``JAX_HOST_EVAL_FAULT``)."""
    if isinstance(cfg, (list, tuple)):
        cfg = cfg[0]
    dev = resolve_device(device)
    cfg = Config(cfg)
    pcfg = Config(cfg.get("policy", {}))
    _check_scope(pcfg)
    policy_cls = POLICIES[pcfg.get("type", "muzero")]
    pcfg = deep_merge(policy_cls.default_config(), pcfg)
    pcfg.seed = seed
    env = tensor_env(cfg.env, "eval_muzero")
    check_observation_shape(env, pcfg, policy_cls)
    policy = policy_cls(pcfg, device=dev, seed=seed)
    state = policy.init_train_state()
    if model_path:
        load_checkpoint_lenient(model_path, target=state)
    evaluator = Evaluator(env, policy, cfg.env.get("evaluator_env_num", 3), seed=seed, device=dev)
    return evaluator.eval(n_episodes=n_episodes)
