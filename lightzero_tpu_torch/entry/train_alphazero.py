"""AlphaZero's training entry (``lightzero_tpu/entry/train_alphazero.py``):
self-play collection -> a uniform replay of (obs, visit distribution,
outcome z) samples (a deque of ``replay_buffer_size``, each sample expanded
into its symmetry orbit under ``use_augmentation``) -> ``update_per_collect``
learn steps on batches drawn with replacement -> an eval against the rule
bot every ``eval_freq`` learn steps, until ``max_env_step``,
``max_train_iter`` or the eval's mean outcome reaches ``stop_value``.

The env is ``cfg.env.type`` (tictactoe, connect4, gomoku, go or chess),
built twice with the env-config keys that its constructor takes
(``board_size``, ``n_in_row``, ``komi``, ... and ``env_kwargs``): in
self-play for collection and against the bot for evaluation, whatever
``battle_mode`` the config sets, as the JAX entry does. ``cfg.policy.type``
picks the policy: "alphazero" (the default), "gumbel_alphazero" or
"sampled_alphazero"; the collector stores whatever the policy returns as
``visit_counts`` (the improved policy for Gumbel AlphaZero) as the policy
target. Checkpoints: ``ckpt_best`` and ``params_best`` on a new best eval,
``ckpt_final`` at the end.

Usage (on the card, or with ``device="cpu"``)::

    from lightzero_tpu_torch.configs.tictactoe_alphazero_bot_mode import main_config
    from lightzero_tpu_torch.entry import train_alphazero
    policy, state, stats = train_alphazero(main_config, seed=0, max_env_step=200_000)

``eval_alphazero`` loads a checkpoint (or params export) and plays it
against the bot.
"""
from __future__ import annotations

import inspect
import os
from collections import deque
from typing import Dict, Optional, Union

import numpy as np
import torch

from lightzero_tpu_torch.config import Config, compile_config, deep_merge
from lightzero_tpu_torch.envs import ChessEnv, Connect4Env, GoEnv, GomokuEnv, TicTacToeEnv
from lightzero_tpu_torch.ops import visit_count_temperature
from lightzero_tpu_torch.ops.board_augment import get_augmented_data
from lightzero_tpu_torch.policy.alphazero import AlphaZeroPolicy, AZTrainBatch
from lightzero_tpu_torch.policy.gumbel_alphazero import GumbelAlphaZeroPolicy
from lightzero_tpu_torch.policy.sampled_alphazero import SampledAlphaZeroPolicy
from lightzero_tpu_torch.utils.checkpoint import (
    load_checkpoint_lenient,
    save_checkpoint,
    save_params_export,
)
from lightzero_tpu_torch.utils.device import resolve_device
from lightzero_tpu_torch.utils.logger import ExperimentLogger
from lightzero_tpu_torch.workers.alphazero_workers import (
    AlphaZeroBotEvaluator,
    AlphaZeroSelfPlayCollector,
)

BOARD_ENVS = {"tictactoe": TicTacToeEnv, "connect4": Connect4Env, "gomoku": GomokuEnv,
              "go": GoEnv, "chess": ChessEnv}
POLICIES = {"alphazero": AlphaZeroPolicy, "gumbel_alphazero": GumbelAlphaZeroPolicy,
            "sampled_alphazero": SampledAlphaZeroPolicy}


def _policy_cls(cfg: Config):
    policy_type = Config(cfg).get("policy", {}).get("type", "alphazero")
    if policy_type not in POLICIES:
        raise NotImplementedError(
            f"policy type {policy_type!r} is not an AlphaZero policy (POLICIES: {list(POLICIES)})")
    return POLICIES[policy_type]


def build_env(env_cfg: Config, battle_mode: str):
    """The board env of ``env_cfg.type`` in ``battle_mode``, with the env-config
    keys that match its constructor's arguments and ``env_kwargs``."""
    key = env_cfg.get("type", "tictactoe")
    if key not in BOARD_ENVS:
        raise NotImplementedError(f"{key!r} is not a board env (BOARD_ENVS: {list(BOARD_ENVS)})")
    env_cls = BOARD_ENVS[key]
    params = inspect.signature(env_cls.__init__).parameters
    kwargs = {k: v for k, v in dict(env_cfg).items()
              if k in params and k not in ("self", "battle_mode")}
    kwargs.update(dict(env_cfg.get("env_kwargs", {})))
    return env_cls(battle_mode=battle_mode, **kwargs)


def train_alphazero(
    cfg,
    seed: int = 0,
    model_path: Optional[str] = None,
    max_env_step: int = int(1e6),
    max_train_iter: int = int(1e9),
    device: Optional[Union[str, torch.device]] = None,
):
    """Train AlphaZero on ``cfg`` (``{"env": ..., "policy": ...}``, or
    ``[main_config, create_config]``). Runs on ``device``: ``cuda`` unless
    the caller names another. ``model_path`` warm-starts from a checkpoint
    or params export. Returns ``(policy, state, stats)``: ``stats`` holds
    ``env_steps``, ``train_iter``, ``best_return`` and ``replay``."""
    if isinstance(cfg, (list, tuple)):
        cfg = cfg[0]
    dev = resolve_device(device)
    policy_cls = _policy_cls(cfg)
    cfg = compile_config(cfg, policy_cls.default_config(), seed)
    pcfg = cfg.policy
    selfplay_env = build_env(cfg.env, "self_play_mode")
    eval_env = build_env(cfg.env, "play_with_bot_mode")

    policy = policy_cls(pcfg, selfplay_env, device=dev, seed=seed)
    state = policy.init_train_state()
    if model_path:
        state = load_checkpoint_lenient(model_path, target=state)
    collector = AlphaZeroSelfPlayCollector(selfplay_env, policy,
                                           cfg.env.get("collector_env_num", 8), seed=seed + 1)
    evaluator = AlphaZeroBotEvaluator(eval_env, policy, cfg.env.get("evaluator_env_num", 4),
                                      seed=seed + 2)
    logger = ExperimentLogger(cfg.exp_name, "train")
    ckpt_dir = os.path.join(cfg.exp_name, "ckpt")
    replay = deque(maxlen=int(pcfg.replay_buffer_size))
    rng_np = np.random.RandomState(seed)
    batch_size = int(pcfg.batch_size)
    stop_value = cfg.env.get("stop_value", 1.0)
    eval_freq = int(pcfg.eval_freq)
    upc = int(pcfg.update_per_collect)
    train_iter = 0
    last_eval = -eval_freq - 1
    logger.info(f"train_alphazero: exp={cfg.exp_name} device={dev} max_env_step={max_env_step} "
                f"sims={pcfg.num_simulations} batch={batch_size}")

    while collector.total_env_steps < max_env_step and train_iter < max_train_iter:
        temperature = visit_count_temperature(
            pcfg.get("manual_temperature_decay", False),
            pcfg.get("fixed_temperature_value", 1.0),
            pcfg.get("threshold_training_steps_for_final_temperature", int(1e5)),
            train_iter,
        )
        if train_iter - last_eval >= eval_freq:
            last_eval = train_iter
            res = evaluator.eval(cfg.env.get("n_evaluator_episode", 4))
            logger.log_scalars({"eval_mean_return": res["mean_return"], "win_rate": res["win_rate"],
                                "draw_rate": res["draw_rate"]},
                               collector.total_env_steps, prefix="evaluator/")
            logger.info(f"iter={train_iter} envstep={collector.total_env_steps} EVAL "
                        f"return={res['mean_return']:.2f} win={res['win_rate']:.2f} "
                        f"draw={res['draw_rate']:.2f}")
            if res["new_best"]:
                save_checkpoint(state, os.path.join(ckpt_dir, "ckpt_best"))
                save_params_export(state, os.path.join(ckpt_dir, "params_best"))
            if res["mean_return"] >= stop_value:
                logger.info("stop_value reached; stopping.")
                break

        samples, cstats = collector.collect(temperature=temperature,
                                            num_episodes=int(pcfg.n_episode))
        if bool(pcfg.get("use_augmentation", False)):
            for s in samples:
                replay.extend(get_augmented_data(np.asarray(s.obs), np.asarray(s.probs), s.z))
        else:
            replay.extend(samples)
        logger.log_scalars({"steps_per_sec": cstats["steps_per_sec"], "replay": len(replay)},
                           collector.total_env_steps, prefix="collector/")
        if len(replay) < batch_size:
            continue
        logs: Dict = {}
        for _ in range(upc):
            idx = rng_np.randint(0, len(replay), size=batch_size)
            batch = AZTrainBatch(
                obs=torch.from_numpy(np.stack([replay[i].obs for i in idx])).to(dev),
                target_policy=torch.from_numpy(np.stack([replay[i].probs for i in idx])).to(dev),
                target_value=torch.from_numpy(
                    np.asarray([replay[i].z for i in idx], np.float32)).to(dev),
            )
            state, logs = policy.forward_learn(state, batch)
            train_iter += 1
        if not np.isfinite(float(logs["total_loss"])):
            save_checkpoint(state, os.path.join(ckpt_dir, "ckpt_nan"))
            logger.close()
            raise RuntimeError(f"non-finite total_loss={float(logs['total_loss'])} at iter "
                               f"{train_iter} (state saved to ckpt/ckpt_nan)")
        logger.log_scalars(logs, collector.total_env_steps, prefix="learner/")
        logger.info(f"iter={train_iter} envstep={collector.total_env_steps} "
                    f"loss={float(logs['total_loss']):.3f} sps={cstats['steps_per_sec']:.0f}")

    save_checkpoint(state, os.path.join(ckpt_dir, "ckpt_final"))
    logger.close()
    return policy, state, dict(env_steps=collector.total_env_steps, train_iter=train_iter,
                               best_return=evaluator.best_return, replay=replay)


def eval_alphazero(cfg, seed: int = 0, model_path: Optional[str] = None, n_episodes: int = 5,
                   device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Load a checkpoint or params export (``model_path``; random weights from
    ``seed`` without one) and play it against the rule bot on
    ``cfg.env.evaluator_env_num`` envs until ``n_episodes`` games have
    ended. Runs on ``device``: ``cuda`` unless the caller names another.
    Writes nothing. Returns the ``AlphaZeroBotEvaluator.eval`` record."""
    if isinstance(cfg, (list, tuple)):
        cfg = cfg[0]
    dev = resolve_device(device)
    cfg = Config(cfg)
    policy_cls = _policy_cls(cfg)
    pcfg = deep_merge(policy_cls.default_config(), Config(cfg.get("policy", {})))
    eval_env = build_env(cfg.env, "play_with_bot_mode")
    policy = policy_cls(pcfg, eval_env, device=dev, seed=seed)
    state = policy.init_train_state()
    if model_path:
        load_checkpoint_lenient(model_path, target=state)
    evaluator = AlphaZeroBotEvaluator(eval_env, policy, cfg.env.get("evaluator_env_num", 4),
                                      seed=seed)
    return evaluator.eval(n_episodes)
