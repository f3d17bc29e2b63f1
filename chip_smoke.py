#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (lightzero_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of a fixed size, in one process:
  1. card: the GPU's name and power limit (nvidia-smi);
  2. build: nvcc compiles every kernel of the port, and g++ the replay
     buffer's core, into lightzero_tpu_torch/_build/, all at once, while
     torch.profiler's device tracing starts and stops once (its first start
     costs seconds);
  3. kernel vs plain: the descent kernel's branch-free division against '/'
     on 4M random operand pairs and 4M pairs whose quotient lies next to a
     rounding midpoint; each kernel against its plain PyTorch version on
     the card, on numpy-seeded inputs at the shapes the main path gives it,
     at the Atari action count (A=18), with more actions than a warp has
     lanes (A=37), and with values at the edges of float32; each kernel's
     device time from the replay of a CUDA graph of launches (the wrapper's
     host time left out) and its time launch to launch through the wrapper
     (host time included), its time per depth level, and a latency figure:
     (deepest descent + 1) x one dependent L2 load, timed with
     csrc/latency_probe.cu, which also gives the floor of one launch. Then
     the backup kernel (csrc/fused_backup.cu) against its plain version on
     the arguments of captured backups, every tree tensor bitwise: the
     search cell's shape (B=2,048, A=6, 6x6x64 embeddings) at
     BACKUP_CELL_SIMS, timed as the descent is, with its bound from the
     bytes it moves; one simulation of each other CHECK_SEARCHES search
     (terminal stops, A=18, A=37, Gumbel's logits, ReZero's reused value,
     Stochastic MuZero's chance nodes). Then the channel-norm kernel pair
     (csrc/channel_norm.cu) against its plain version at the benchmark
     cells' shapes (CHANNEL_NORM_SHAPES): the output and the gradients'
     gaps, the forward's and the backward's device times beside their
     bounds, the plain version's and F.layer_norm + relu's (library_ms);
  4. the main path: the Evaluator plays CartPole with the CartPole MuZero config
     at full width (25 simulations, 3 envs) until each env ends an episode,
     with the launch counters read around it; then a small batch searched on
     the card agrees with the same search on the CPU;
  5. bench shape: batch_puct_search through MuZeroPolicy at bench.py's shapes
     (B=1024, 50 simulations): the median of 5 searches through the kernel
     after a warm-up, one through the plain descent; equal visit counts. One
     more search under torch.profiler gives the kernel's device time per
     simulation and the device's busy share of the search wall. The warm-up
     search keeps the descent's inputs of simulations 1, 25 and 50, and
     phase 3 is run once more on those tables;
  6. train: train_muzero on the CartPole MuZero config at full width (batch
     256, latent 128, projector 1024, 25 simulations, 8 collect envs), exp
     dir under a temporary directory, for TRAIN_ITERS = 100 learn steps
     with an eval at iter 0: finite losses, the target net equal to the
     online net after the copy at iter 100, descent launches = (collect + eval
     searches) x 25; one learn step on the card against one on the CPU from
     the same params and batch; one sample at reanalyze_ratio=0.25 adds 25
     launches; the median learn-step time over TIMED_LEARN_STEPS steps (CUDA
     events), the collect rate, and a torch.profiler pass over 5 learn steps
     (both profiler passes record the device's events only);
  7. efficientzero: the CartPole EfficientZero config at full width (latent
     128, LSTM 128, supports of 601 atoms, 25 simulations), whose search is
     the pUCT search through the descent kernel: the Evaluator on 3 envs
     until each ends an episode (launches = env steps x 25); a batch of 4
     searched on the card against the same search on the CPU; the descent
     inputs of one eval search (simulations 1, 13 and 25) rerun kernel
     against plain as in phase 3; train_muzero with the device left unset
     and its searches cut to SHORT_TRAIN_SIMS = 5 simulations: an eval at
     iter 0, one collect round and 20 learn steps, launches = (collect +
     eval searches) x 5, its collect round SHORT_COLLECT_STEPS batched steps
     over twice the config's collect envs; one learn step on the card
     against one on the
     CPU; the median learn-step time;
  8. gumbel_muzero: the CartPole Gumbel MuZero config (10 simulations, 2
     considered actions), whose collect and eval search is the Gumbel
     search in plain PyTorch: the Evaluator on 3 envs, episodes truncated
     at GUMBEL_EVAL_STEPS, adds no descent
     launch (its wall as a user runs it), then a second eval with every
     descent timed between two device syncs, for the descent's share of
     that instrumented wall; a batch of 4 searched on
     the card against the CPU with the same Gumbel table; a short
     train_muzero run as in phase 7 (no launch) and one reanalyze sample,
     which searches with the pUCT search (5 launches); one learn step on
     the card against one on the CPU; the median learn-step time;
  9. stochastic_muzero: the 2048 Stochastic MuZero config at full width
     (observations 4x4x16, 4 actions, 32 chance outcomes, latent 256,
     supports of 601 atoms, 50 simulations), whose search takes the
     generic descent in plain PyTorch (no kernel launch): the Evaluator on
     3 envs with episodes truncated at STOCH_EVAL_STEPS env steps; a second
     eval, truncated at STOCH_TIMED_EVAL_STEPS, with every descent timed
     between two device syncs; a batch of 4 numpy-seeded boards searched on
     the card and on the CPU with the same Dirichlet noise, the same chance
     draws and tie_break='first'; a short train_muzero run as in phase 7
     at STOCH_TRAIN_SIMS simulations with episodes truncated at
     STOCH_TRAIN_EPISODE_STEPS (its eval runs
     that many steps, its collect round SHORT_COLLECT_STEPS over 16 envs,
     512 transitions); one learn step on the card against one on the CPU; the
     median learn-step time;
 10. sampled: the Pendulum Sampled MuZero and Sampled EfficientZero configs
     at full width (observation 3, action dimension 1, K=20 sampled
     actions, latent 128, LSTM 128, supports of 601 atoms, 50 simulations),
     whose searches run the descent kernel on its row-read route (A=K=20 >
     8): for each policy, the Evaluator on 3 envs with episodes truncated
     at SAMPLED_EVAL_STEPS env steps (launches = env steps x 50); a batch of
     4 numpy-seeded Pendulum states searched on the card and on the CPU
     with the same root and per-simulation candidate draws, the same
     Dirichlet noise and tie_break='first'; a short train_muzero run as in
     phase 7 with episodes truncated at SAMPLED_TRAIN_EPISODE_STEPS, so that
     one collect round of 64 steps x 8 envs fills the batch of 256, and
     stop_value out of reach (launches = (collect + eval searches) x 50);
     one learn step on the card against one on the CPU; the median
     learn-step time. For Sampled MuZero also the descent inputs of one
     eval search at simulations 1, 25 and 50, rerun kernel against plain as
     in phase 3;
 11. rezero_history: ReZero, MuZero-Context and MuZero-RNN-full-obs on
     CartPole at full width (latent 128, 25 simulations, batch 256).
     ReZero (supports of 51 atoms): a short train_muzero run as in phase 7,
     its episodes truncated at REZERO_TRAIN_EPISODE_STEPS, whose collect
     round triggers the whole-buffer reuse reanalyze (groups of 160
     episodes, backward in time): launches = (collect + eval searches) x 5
     + 5 x groups, since only each group's first search takes the kernel
     and the reuse searches the generic descent (5 x (longest episode - 1)
     descents a group), and the logged count of reanalyzed transitions is
     that of the newest episodes covering 75 % of the buffer; a reuse search
     of 4 numpy-seeded CartPole states on the card and on the CPU with the
     same Dirichlet noise, true actions and reused values and
     tie_break='first' (no launch); one plain reanalyze_buffer
     (reuse_search=False) of the trained buffer, 5 launches a batch of 160.
     MuZero-Context: the Evaluator on 3 envs (launches = env steps x 25)
     through the stateful path; the root latents of 7 stateful steps on the
     card against the CPU, across an episode reset after step 2 and the
     context reset at step 5; a short train_muzero run as in phase 7.
     MuZero-RNN-full-obs (the CartPole MuZero config with its policy type,
     GRU 128): the Evaluator, a batch of 4 searched on the card against the
     CPU, a short train_muzero run as in phase 7 with its learn step on the
     card against the CPU;
 12. grid: the conv stack on the MinAtar-class grids at the zoo configs'
     full width. Grid Breakout MuZero (observations 10x10x4, A=3, 32
     channels, 1 res block, supports of 101 atoms, SSL projector 1024 over
     the 3200-wide latent, 25 simulations) and Space Invaders EfficientZero
     (A=4, LSTM 256 over the 1600-wide 1x1 reduction), both searching
     through the descent kernel's small-A route: for each, the Evaluator on
     3 envs with episodes truncated at GRID_EVAL_STEPS (launches = env
     steps x 25); a batch of 4 grid states searched on the card and on the
     CPU with the same Dirichlet noise and tie_break='first'; the descent
     inputs of one eval search (simulations 1, 13, 25) rerun kernel against
     plain as in phase 3; a short train_muzero run as in phase 7 with
     episodes truncated at GRID_TRAIN_EPISODE_STEPS (launches = (collect +
     eval searches) x 5), one learn step on the card against one on the
     CPU and the median learn-step time. Then one initial and one recurrent
     inference of conv MuZero at the Atari width (96x96x12, 64 channels,
     the DownSample pyramid) on 4 seeded frames, card against CPU;
 13. board: the bsuite and memory probes, two-player search, AlphaZero and the
     board games, at the zoo configs' full width. Catch MuZero (obs 50, A=3,
     latent 64, 25 simulations) and Memory EfficientZero (obs 8, A=4, latent
     128, LSTM, 50 simulations, unroll 12), whose searches launch the descent
     kernel on its small-A route: each Evaluator on 3 envs (launches = env
     steps x simulations), Catch's eval descent inputs (simulations 1, 13,
     25) rerun kernel against plain as in phase 3, a short train_muzero run
     as in phase 7, its stop_value out of reach (launches = (collect + eval
     searches) x 5) with its learn step on the card against the CPU.
     TicTacToe AlphaZero (3x3x3 planes, 32 channels, 1 res block, 25 simulations; the env is the
     search's simulator and its players alternate, so the search takes the
     generic descent): 4 positions searched on the card and on the CPU with
     the same Dirichlet noise and tie_break='first', one self-play collect of
     8 games, AZ_EVAL_EPISODES games against the rule bot, a train_alphazero
     run at AZ_TRAIN_SIMS = 8 simulations and SHORT_TRAIN_ITERS learn steps
     with its learn step on the card against the CPU; no launch. Connect4
     MuZero (the fine-tune config: conv 64 channels, A=7, 50 simulations, bot
     mode, mirror augmentation; seeded weights): the Evaluator against the rule bot on 3 envs with its generic
     descent timed, 4 positions searched on the card and on the CPU, a short
     train_muzero run at C4_TRAIN_SIMS simulations with mirror-augmented
     batches; no descent launch. The eval's and one more learn step's
     channel-norm launches each equal the conv networks' sites x calls (one
     a site forward, two more backward). (The committed Connect4 params are an orbax
     checkpoint, zstd-compressed OCDBT, which the card's machine cannot read
     without JAX: tests/connect4_params_eval.py plays them on the CPU.)
 14. big_boards: Go, Gomoku and Chess at the zoo configs' full width, every
     search two-player (or bot-mode) on the generic or the Gumbel descent,
     no launch. Go 6x6 AlphaZero (64 channels, 2 res blocks, 37 actions, 60
     simulations; games cut at GO_MAX_MOVES plies), Gomoku Gumbel AlphaZero
     (32 simulations, 8 considered actions) and Gomoku Sampled AlphaZero
     (K=18 of 36, 50 simulations): each 4 positions searched on the card
     and on the CPU with the same draws (Dirichlet noise; the Gumbel table;
     the root's and every simulation's Gumbel-top-K draws) and
     tie_break='first', then a train_alphazero run at AZ_TRAIN_SIMS = 8
     simulations whose iter-0 eval plays BIG_EVAL_EPISODES games against the
     rule bot on 5 envs with its descents timed, one self-play collect of 8
     games (more until the replay holds a batch) and SHORT_TRAIN_ITERS learn
     steps, one learn step on the card against the CPU and the median
     learn-step time. Chess
     AlphaZero (96 channels, 6 res blocks, 4672 actions, 50 simulations):
     the bot eval on 5 envs, games cut at CHESS_MAX_MOVES plies, and perft
     to depth 2 from the start position and Kiwipete with the card's
     legal_mask_full (400 and 2,039). Gomoku MuZero (conv 32 channels, 50
     simulations; downsample=False, since the zoo file's default
     downsampling leaves no cell, on which the JAX package fails too): the
     Evaluator against the bot with its descent timed and a short
     train_muzero run at BIG_MZ_TRAIN_SIMS simulations. A summary line per
     config gives eval s per env step, the descent's ms, levels and share
     of the eval wall, the learn step, the collect rate and the launches;
 15. unizero: the transformer world model, its search carrying a KV cache
     per tree node, at full width with random weights from seed 0. UniZero
     with the Grid Breakout ws config (conv 64 channels over 10x10x4, embed
     256, 2 layers, 8 heads, 24 tokens, supports of 101 atoms, 25
     simulations, batch 256, unroll 10, drift correction of depth 2,
     group_kl), whose searches launch the descent kernel on its small-A
     route (A=3): the Evaluator on 3 envs with episodes cut at
     UZ_EVAL_STEPS (launches = env steps x 25); UZ_CONTEXT_STEPS stateful
     steps of 4 grid envs from an empty context on the card and on the CPU
     (eval steps, then a collect step with the same Dirichlet noise;
     tie_break='first'): visit counts equal, values within VALUE_TOL; the
     eval search's descent inputs (simulations 1, 13, 25) rerun kernel
     against plain; a short train_muzero run as in phase 7 with episodes
     cut at UZ_TRAIN_EPISODE_STEPS and training from the first collect
     round, searching with SHORT_TRAIN_SIMS (launches = (collect + eval
     searches) x 5), one learn step on
     the card against the CPU and the
     median of UZ_TIMED_LEARN_STEPS learn steps. Sampled UniZero with the
     Pendulum config (K=16, 50 simulations; the row-read route): the same,
     cut like phase 10 (its card-vs-CPU search with injected candidate
     draws and noise from a fresh context, its short run at SHORT_TRAIN_SIMS
     simulations). A summary gives eval s per env step, learn-step ms, the
     collect rate, the bytes of one node's KV cache and the phase's wall.
 16. multitask: ScaleZero v3 at full width (Sampled UniZero multitask over
     3 Pendulum tasks: embed 256, 2 layers, 8 heads, 22 tokens, K=20, 25
     simulations, batch 96, unroll 10, LoRA r=4 over 2 stages; random
     weights) through train_multitask_balance: an eval at iter 0 and one
     collect round per task (episodes cut at MT_EPISODE_STEPS, collect
     rounds of MT_COLLECT_STEPS batched steps) and 20 learn steps (launches
     = the sum over tasks of (eval + collect searches) x 25, row-read
     route); task 0's eval descent tables (simulations 1, 13, 25) kernel
     against plain; each task view's search card vs CPU with injected
     candidates and noise; one learn step on the default path and one on
     the CAGrad path card vs CPU (the CAGrad weights within CAGRAD_W_ATOL
     and on the simplex); a forced set_curriculum_stage(1) whose learn step
     leaves the backbone bit-unchanged and moves the stage-1 adapters; the
     CartPole + Pendulum balance config and the smoke's own two-task
     CartPole muzero_multitask run, cut the same way and at
     SHORT_TRAIN_SIMS simulations (prefetch route, A=2);
     ddp_learn_step in a one-rank NCCL group (InfiniBand and NVLS off)
     against the plain learn step, its setup, step and teardown timed.
     A summary gives each task's eval s per env step, the learn-step ms
     (default and CAGrad), the collect rates and the phase's wall;
 17. host: the host envs' path, RND, eval_offline and HarmonyDream. (a) One
     line says which of gymnasium, Box2D, mujoco and dm_control import on
     this machine, with their versions. (b) train_muzero's host path with
     the CartPole MuZero config at full width (25 simulations, latent 128,
     batch 256) over StandInHostEnv, a vec env with HostVecEnv's interface
     and seeding over the port's CartPoleEnv on the CPU, defined here and
     not in the package, so that the path runs whatever (a) found: an eval
     at iter 0 through HostEvaluator, one collect round through
     HostCollector and SHORT_TRAIN_ITERS learn steps, launches = (collect +
     eval batched steps) x 25, its learn step card vs CPU; then
     HOST_COMPARED_STEPS batched eval steps over the stand-in on the card
     and on the CPU from the same weights and seeds (equal actions and visit
     counts, searched values within VALUE_TOL); the host path's eval s per
     env step and collect env steps/s beside phase 4's and phase 6's
     TensorEnv figures. (c) Where their libraries import, mtcar_muzero
     (gymnasium) and lunarlander_disc_muzero (Box2D) through train_muzero
     cut like phase 7 (SHORT_TRAIN_SIMS simulations, episodes cut at
     HOST_EPISODE_STEPS, stop_value out of reach); where they do not, a
     line says these configs did not run. (d) The zoo's memory_muzero_rnd
     at full width (latent 128, 50 simulations, batch 256, unroll 12)
     through train_muzero_with_reward_model, cut like phase 7 at its 50
     simulations, its collect round RND_COLLECT_STEPS batched steps: launches = (collect + eval searches) x 50, one RND train
     step and one estimate card vs CPU within RND_RTOL, the learn step card
     vs CPU and timed, and the RND train and estimate ms per episode.
     (e) The CartPole MuZero config with harmony_balance: a learn step card
     vs CPU (compare_learn_steps) on a batch of (b)'s buffer, timed learn
     steps, and the three scalars moved. (f) eval_offline over (d)'s
     checkpoints (ckpt_final), launches = eval searches x 50;
 18. rest_of_item_20: (a) UniZero at the ws width (phase 15's config, its
     buffer and target net) with the reconstruction loss and the LPIPS
     perceptual term (LPIPS_RECON_WEIGHT, LPIPS_PERCEPTUAL_WEIGHT) on a
     batch of 256 x 11 frames of 10x10x4: one learn step card vs CPU,
     lpips_distance card vs CPU within LPIPS_RTOL on LPIPS_COMPARED_FRAMES
     of them, LPIPS_TIMED_STEPS learn
     steps timed with the term and without it, and the term's share of the
     step's device time from two torch.profiler passes through
     utils/profiling.torch_trace (whose Chrome trace must hold CUDA
     kernels). (b) loss_landscape_api in 1-D at LANDSCAPE_POINTS points on
     that policy and batch, card vs CPU on one direction, the models'
     parameters bit-unchanged. (c) MuZeroAgent on the bundled
     gym_cartpole_v0 config at full width, episodes cut at
     AGENT_EPISODE_STEPS: train (an eval, one collect round cut like phase
     7's, AGENT_LEARN_STEPS learn steps; launches = (collect + eval
     searches) x 25), deploy with replay (launches = env steps x 25; a
     replay per episode, episode_return the sum of its rewards). (d)
     augment_batch with injected draws and the analysis metrics card vs
     CPU, and the gated Atari config's ImportError.

The last lines are the card's name and power limit, one JSON object with a
record per kernel, and {"ok": true, "device": {...}}; that last line is printed
only when every phase passed. Without a CUDA device the script exits non-zero
and prints no result. A watchdog ends a run that has not finished in
WATCHDOG_S = 600 s.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import faulthandler
import functools
import importlib
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from lightzero_tpu_torch import _build
from lightzero_tpu_torch.models import channel_norm as cn
from lightzero_tpu_torch.configs.cartpole_efficientzero import main_config as ez_config
from lightzero_tpu_torch.configs.cartpole_gumbel_muzero import main_config as gumbel_config
from lightzero_tpu_torch.configs.cartpole_muzero import main_config
from lightzero_tpu_torch.configs.cartpole_muzero_context import main_config as context_config
from lightzero_tpu_torch.configs.cartpole_rezero_mz import main_config as rezero_config
from lightzero_tpu_torch.configs.game_2048_stochastic_muzero import main_config as stoch_config
from lightzero_tpu_torch.configs.pendulum_sampled_efficientzero import main_config as sez_config
from lightzero_tpu_torch.configs.pendulum_sampled_muzero import main_config as smz_config
from lightzero_tpu_torch.configs.breakout_grid_muzero import main_config as breakout_config
from lightzero_tpu_torch.configs.space_invaders_grid_efficientzero import (
    main_config as invaders_config,
)
from lightzero_tpu_torch.configs.catch_muzero import main_config as catch_config
from lightzero_tpu_torch.configs.connect4_muzero_ft import main_config as connect4_config
from lightzero_tpu_torch.configs.memory_efficientzero import main_config as memory_config
from lightzero_tpu_torch.configs.tictactoe_alphazero_bot_mode import main_config as ttt_az_config
from lightzero_tpu_torch.configs.chess_alphazero_bot_mode import main_config as chess_az_config
from lightzero_tpu_torch.configs.go6_alphazero_bot_mode import main_config as go6_az_config
from lightzero_tpu_torch.configs.gomoku_gumbel_alphazero import main_config as gomoku_gaz_config
from lightzero_tpu_torch.configs.gomoku_muzero_bot_mode import main_config as gomoku_mz_config
from lightzero_tpu_torch.configs.gomoku_sampled_alphazero_bot_mode import (
    main_config as gomoku_saz_config,
)
from lightzero_tpu_torch.configs.breakout_grid_unizero_ws import main_config as uz_ws_config
from lightzero_tpu_torch.configs.pendulum_sampled_unizero import main_config as suz_config
from lightzero_tpu_torch.configs.pendulum_suite_scalezero_v3 import task_configs as scalezero_v3
from lightzero_tpu_torch.configs.cartpole_pendulum_balance import task_configs as balance_tasks
from lightzero_tpu_torch.configs.mtcar_muzero import main_config as mtcar_config
from lightzero_tpu_torch.configs.lunarlander_disc_muzero import main_config as lunarlander_config
from lightzero_tpu_torch.configs.memory_muzero_rnd import main_config as rnd_config
from lightzero_tpu_torch.config import deep_merge
from lightzero_tpu_torch.buffers import GameBuffer
from lightzero_tpu_torch.entry import (
    eval_offline,
    train_alphazero,
    train_multitask_balance,
    train_muzero,
    train_muzero_multitask,
    train_muzero_with_reward_model,
)
from lightzero_tpu_torch.entry.train_muzero_multitask import combine_task_batches
from lightzero_tpu_torch.parallel.ddp import ddp_learn_step
from lightzero_tpu_torch.parallel.dryrun import random_batch
from lightzero_tpu_torch.entry.train_alphazero import build_env
from lightzero_tpu_torch.entry.train_muzero import create_env
from lightzero_tpu_torch.envs import (
    BreakoutGridEnv,
    CartPoleEnv,
    CatchEnv,
    Connect4Env,
    Game2048Env,
    MemoryEnv,
    PendulumEnv,
    SpaceInvadersGridEnv,
    TicTacToeEnv,
)
from lightzero_tpu_torch.envs.board import chess
from lightzero_tpu_torch.envs.game_2048 import legal_moves
from lightzero_tpu_torch.models import (
    AlphaZeroModel,
    EfficientZeroModel,
    MuZeroModel,
    MuZeroRNNModel,
    StochasticMuZeroModel,
    UniZeroModel,
)
from lightzero_tpu_torch.models.common import (
    LAYER_NORM_EPS,
    DynamicsNetworkConv,
    MLPTorso,
    PredictionNetworkConv,
    RepresentationNetworkConv,
    lecun_normal_,
)
from lightzero_tpu_torch.models.sampled_muzero import SampledHeads
from lightzero_tpu_torch.policy import (
    AlphaZeroPolicy,
    EfficientZeroPolicy,
    GumbelAlphaZeroPolicy,
    GumbelMuZeroPolicy,
    MuZeroContextPolicy,
    MuZeroPolicy,
    MuZeroRNNFullObsPolicy,
    SampledAlphaZeroPolicy,
    SampledEfficientZeroPolicy,
    SampledMuZeroPolicy,
    SampledUniZeroPolicy,
    StochasticMuZeroPolicy,
    UniZeroPolicy,
)
from lightzero_tpu_torch.policy.alphazero import AZTrainBatch
from lightzero_tpu_torch.search import gumbel, puct
from lightzero_tpu_torch.search.fused_backup import fused_backup, fused_backup_reference
from lightzero_tpu_torch.search.fused_backup_checks import CHECK_SEARCHES, check_search
from lightzero_tpu_torch.search.tree import map_embedding
from lightzero_tpu_torch.search.fused_traverse import (
    SYNTHETIC_SEED,
    SYNTHETIC_SHAPES,
    check_inputs,
    fused_traverse,
    fused_traverse_reference,
    kernel_route,
)
from lightzero_tpu_torch.reward_model import RNDRewardModel
from lightzero_tpu_torch.agent import MuZeroAgent
from lightzero_tpu_torch.configs.atari_muzero import main_config as atari_config
from lightzero_tpu_torch.loss_landscape import loss_landscape_api, random_direction
from lightzero_tpu_torch.models import analysis
from lightzero_tpu_torch.ops.augment import augment_batch
from lightzero_tpu_torch.ops.lpips import lpips_distance
from lightzero_tpu_torch.utils.profiling import torch_trace
from lightzero_tpu_torch.workers import (
    AlphaZeroBotEvaluator,
    AlphaZeroSelfPlayCollector,
    Evaluator,
    HostCollector,
    HostEvaluator,
    RolloutCollector,
)
from port_bench.flops import descent_bytes_ops

# the descent's and the backup's launchers, as ``_build.launches`` counts them
DESCENT, BACKUP = "fused_traverse_launch", "fused_backup_launch"

# phases 9 and 10 took the script to 259 s on one host and to 371 s on a
# slower one (every phase 1.4-1.9x slower there), 29 s short of the 400 s
# this watchdog had through phase 9; 600 s is half the 1200 s a run may take.
# Phase 11 took the script to 317 s on the first host (with 200 learn steps
# in phase 6, now 100). With phase 15 the script took 533-767 s on H100
# hosts whose speed differed by up to 1.5x, so the short training runs of
# phases 7 and 11-13 search with SHORT_TRAIN_SIMS simulations. With phase 17
# it took 483-505 s on one host and passed 600 s on one 1.5x slower, so the
# short runs' searches, the AlphaZero runs' and the timed learn steps were
# cut again (below) and the profiler passes record the device only
WATCHDOG_S = 600
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside the
# tensor cores; the bound of a kernel is the larger of bytes/rate, ops/rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# kernel vs plain: path, action, depth, parent, leaf and flags exact; the
# recorded stats are copies of table entries and must agree to 1e-6
STATS_RTOL = STATS_ATOL = 1e-6
# card vs CPU search on the same weights: float32 matmuls in another order
VALUE_TOL = 1e-4
# h^-1's epsilon (ops/scaling.py): a value read off a categorical support is
# h^-1 of the atoms' expectation, computed in float32
H_EPS = 1e-3
# card vs CPU root latents of MuZero-Context: float32 matmuls and LayerNorm
# statistics in another order
LATENT_TOL = 1e-5
# launches in one CUDA graph when timing a kernel, and searches timed at the
# bench shape (the median is reported)
GRAPH_REPS = 50
BENCH_SEARCHES = 5
# simulations of the bench search whose descent inputs phase 3 reruns
CAPTURED_SIMS = (1, 25, 50)
EDGE_SHAPES = [(256, 4, 26), (256, 18, 26)]
# the backup kernel's cases: the simulations of the search cell's shape
# whose backup inputs are rerun kernel against plain and timed, and the one
# simulation of every other CHECK_SEARCHES search
BACKUP_CELL_SIMS = (1, 25, 49)
BACKUP_OTHER_SIM = 10
# the channel-norm kernel's cases (label, NHWC map shape, residual): the
# shapes the benchmark's cells give it. The search's leaf maps (2,048 roots,
# 6x6x64 latents, 16-channel heads) and its first 48x48x32 map of the root;
# the encoder of UniZero's and of the MoE cell's learner (704 and 5,632
# frames of 64x64: 32x32x32, then 16x16x64 maps); MuZero's learner (256 rows
# x 6 frames of 96x96: 48x48x32). Maps under the card's 50 MB L2 stay in it
# from one timed launch to the next, as in the search they were just written
CHANNEL_NORM_SHAPES = (
    ("search.transition", (2048, 6, 6, 64), True),
    ("search.head", (2048, 6, 6, 16), False),
    ("search.initial", (2048, 48, 48, 32), False),
    ("unizero_learn.encoder", (704, 32, 32, 32), False),
    ("moe_learn.encoder", (5632, 32, 32, 32), False),
    ("moe_learn.encoder_res", (5632, 16, 16, 64), True),
    ("muzero_learn.encoder", (1536, 48, 48, 32), True),
)
L2_BYTES = 50 * 2 ** 20
# the kernel's gradients against the plain formula in float64 given the
# kernel's output, each gap over the tensor's largest entry: a few float32
# steps; dgamma and dbeta are sums over every row, which the kernel takes in
# double (the output is held to aten's bitwise)
CHANNEL_NORM_TOL = dict(dx=2e-5, dw=1e-6, db=1e-6)
# train phase: learn steps of the CartPole run (100, where the target net is
# copied: the run's depth was halved from 200 when phase 11 came, to keep the
# script within half the run limit on slower hosts), learn steps timed after
# it and after each short run (20 until phase 15 came, 10 until phase 17
# came; phase 15 times 10), learn steps under the profiler
TRAIN_ITERS = 100
TIMED_LEARN_STEPS = 5
PROFILED_LEARN_STEPS = 5
# phases 7 and 8: learn steps of the short train_muzero run, the
# simulations of the EfficientZero eval search whose descent inputs are
# rerun kernel against plain
SHORT_TRAIN_ITERS = 20
# the simulations of the short training runs of phases 7 and 11-13 (their
# evals search with the configs' 25 or 50): each simulation costs a few ms of
# host dispatch, 64 times in a collect round; with phase 15 the script went
# past its watchdog on slower hosts. Phase 10's runs keep their 50: at 10,
# Sampled MuZero's learn-step check failed on its mean predicted value near
# 0 (1.8e-4 relative, against LEARN_LOG_RTOL), as at 16-step episodes.
# (10 until phase 17 came: a batched step costs ~22 ms plus ~4 ms a
# simulation of host dispatch at 8 envs.)
SHORT_TRAIN_SIMS = 5
# the batched steps of those runs' collect round, over twice the configs'
# collect envs: the transitions of the collector's 64 steps over the
# configs' envs in half the steps (64 over the configs' envs until phase 17
# came). Phase 10's runs and the host path's keep the collector's 64.
SHORT_COLLECT_STEPS = 32
EZ_CAPTURED_SIMS = (1, 13, 25)
# phase 8: Gumbel MuZero's two evals truncate CartPole's episodes here (its
# evals ran 54 batched steps, 6 s each, before phase 17 came)
GUMBEL_EVAL_STEPS = 16
# phase 9's short training run searches with STOCH_TRAIN_SIMS simulations,
# its evals with the config's 50: its collect round took 45 s at 50, and
# phase 14 would have taken the script past the watchdog on slower hosts
# (10 until phase 17 came)
STOCH_TRAIN_SIMS = 5
# phase 9: a 2048 episode runs for hundreds of moves, so the evals and the
# short training run truncate episodes at these env steps (the first eval
# at 12 until phase 14 came; phase 10's at 12, phase 12's at 16 and phase
# 13's AlphaZero eval at 10 games were cut for it too)
STOCH_EVAL_STEPS = 4  # 8 until phase 15 came
STOCH_TIMED_EVAL_STEPS = 4  # 6 until phase 17 came
STOCH_TRAIN_EPISODE_STEPS = 16
# phase 10: a Pendulum episode runs 200 steps, so the evals truncate episodes
# at SAMPLED_EVAL_STEPS, and the short training run at
# SAMPLED_TRAIN_EPISODE_STEPS (its eval runs that many steps, and one collect
# round of the collector's 64 steps x 8 envs, 16 episodes, fills the batch);
# the simulations of the Sampled MuZero eval search whose descent inputs are
# rerun kernel against plain. (The evals' cut was 8 until phase 17 came. The
# short runs keep their data: 50 simulations, 32-step episodes and the
# collector's 64 steps over 8 envs. Their learn-step check holds the mean
# predicted value, near 0, to 1e-4 relative; over 16 envs x 32 steps
# Sampled EfficientZero's came to 3.4e-4.)
SAMPLED_EVAL_STEPS = 4
SAMPLED_TRAIN_EPISODE_STEPS = 32
SAMPLED_CAPTURED_SIMS = (1, 25, 50)
# phase 11: ReZero's reuse reanalyze searches each group of episodes once per
# position of its longest episode, so its training run truncates episodes at
# REZERO_TRAIN_EPISODE_STEPS to bound that count; MuZero-Context's card-vs-CPU
# check steps CONTEXT_STEPS times with its context reset every
# context_length_init = 5 steps; the CartPole MuZero config becomes
# MuZero-RNN-full-obs with the JAX default GRU width. (The truncation was 50
# until phase 14 came; 30 keeps the script within the watchdog.)
REZERO_TRAIN_EPISODE_STEPS = 30
CONTEXT_STEPS = 7
RNN_HIDDEN_SIZE = 128
# phase 12: a grid episode runs up to 400-500 steps, so the evals truncate
# episodes at GRID_EVAL_STEPS and the short training runs at
# GRID_TRAIN_EPISODE_STEPS (one collect round of SHORT_COLLECT_STEPS x 16
# envs fills the batch of 256 either way); the Atari-width check's frames and tolerance
# (float32 convolutions of up to 576 terms by other algorithms on the card)
GRID_EVAL_STEPS = 10
GRID_TRAIN_EPISODE_STEPS = 32
GRID_CAPTURED_SIMS = (1, 13, 25)
ATARI_BATCH = 4
ATARI_TOL = 1e-4
# phase 13: the simulations of Catch's eval search whose descent inputs are
# rerun kernel against plain; the games TicTacToe AlphaZero plays against the
# bot; the simulations of Connect4 MuZero's short training run (its 50-
# simulation searches take the generic descent, ~1 s a move on the first
# guess, which would make one collect round of 64 steps run for a minute),
# and the eval envs and episodes of that run
PROBE_CAPTURED_SIMS = (1, 13, 25)
AZ_EVAL_EPISODES = 5
C4_TRAIN_SIMS = 5  # 10 until phase 17 came
C4_TRAIN_EVAL_EPISODES = 3
# phase 14: Go games are cut at GO_MAX_MOVES plies and chess games at
# CHESS_MAX_MOVES (the envs' move cap: a cut Go game is scored, a cut chess
# game drawn), Gomoku games end by themselves within 36 plies; the
# AlphaZero variants' evals play BIG_EVAL_EPISODES games on 5 envs; Gomoku
# MuZero's short training run searches with BIG_MZ_TRAIN_SIMS simulations
# (its eval with the config's 50); perft cases on the card. With an eval of
# its own beside each training run, phase 14 took 115 s on an H100 80GB HBM3
# at 700 W; the AlphaZero variants now time the training run's own eval
GO_MAX_MOVES = 12
# the simulations of the AlphaZero training runs of phases 13 and 14 (self-
# play and, in phase 14, the run's timed iter-0 eval; the configs' 25-60
# until phase 15 came and the script passed its watchdog on slower hosts);
# the card-vs-CPU searches and TicTacToe's own collect and eval keep them;
# 16 until phase 17 came)
AZ_TRAIN_SIMS = 8
CHESS_MAX_MOVES = 2  # 4 until phase 15 came
BIG_EVAL_EPISODES = 5
BIG_MZ_TRAIN_SIMS = 5  # 10 until phase 17 came
PERFT_CASES = (
    ("start", "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1", 2, 400),
    ("kiwipete", "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1", 2,
     2039),
)
# phase 15: UniZero on Grid Breakout at the ws config's width, its eval
# and training episodes cut; Sampled UniZero on Pendulum cut as phase 10.
# Both short runs search with SHORT_TRAIN_SIMS (their evals with the
# configs' 25 and 50; the runs' 25 until phase 17 came: Sampled UniZero's
# collect round took 29.5 s at 50 on the card, 14 s at 25)
UZ_EVAL_STEPS = 10
UZ_TRAIN_EPISODE_STEPS = 32
UZ_CAPTURED_SIMS = (1, 13, 25)
UZ_CONTEXT_STEPS = 3
UZ_TIMED_LEARN_STEPS = 10
SUZ_EVAL_STEPS = 4  # 8 until phase 15 took 60.7 s of its 60 s budget
SUZ_TRAIN_EPISODE_STEPS = 16
SUZ_CAPTURED_SIMS = (1, 25, 50)
# phase 16: ScaleZero v3 (3 Pendulum tasks, embed 256, 8 heads, K=20, 25
# simulations, batch 96, LoRA over 2 stages) through train_multitask_balance
# and two short multitask runs, their episodes cut as phase 15 cuts
# Pendulum's training episodes, and each collect round MT_COLLECT_STEPS
# batched steps (the collector's 64 cut to the episode; both 16 until phase
# 17 came: one collect round of 4 envs still fills ScaleZero's 32 rows a
# task and the balance config's 32)
MT_EPISODE_STEPS = 8
MT_COLLECT_STEPS = 8
MT_CAPTURED_SIMS = (1, 13, 25)
MT_TIMED_LEARN_STEPS = 5  # 10 until phase 17 came
MT_TIMED_CAGRAD_STEPS = 3  # 5 until phase 17 came
# the entries' modules (the package's names of these two are the functions)
MT_ENTRY_MODULES = tuple(importlib.import_module(f"lightzero_tpu_torch.entry.{name}")
                         for name in ("train_muzero_multitask", "train_multitask_balance"))
# the CAGrad weights card vs CPU, absolute: the simplex solve amplifies the
# devices' gradient rounding by the Gram matrix's conditioning
# (tests/test_torch_multitask.py: up to 2.5e-3 at a condition of 250)
CAGRAD_W_ATOL = 1e-3
# phase 17: the host path's card-vs-CPU eval steps, the gymnasium configs'
# episode cut, RND's card-vs-CPU tolerance, and the HarmonyDream scalars
HOST_COMPARED_STEPS = 4  # 8 until phase 18 came
HOST_EPISODE_STEPS = 32
# phase 17: the batched steps of the RND run's collect round: 3 memory
# episodes of 12 steps an env, 288 transitions for the batch of 256 (the
# collector's 64 until the script passed its watchdog on a slower host)
RND_COLLECT_STEPS = 36
RND_RTOL = 1e-5
HARMONY_SCALARS = ("harmony_policy", "harmony_value", "harmony_reward")
# phase 18: the reconstruction and perceptual weights of the LPIPS learn
# steps (breakout_grid_unizero_v7-v9's latent_recon_loss_weight, and the
# perceptual term at the same weight), their timed steps, the landscape's
# points, the Agent's learn steps a collect round and its deploy episodes
LPIPS_RECON_WEIGHT = 0.5
LPIPS_PERCEPTUAL_WEIGHT = 0.5
LPIPS_TIMED_STEPS = 3
LPIPS_RTOL = 1e-4
LANDSCAPE_POINTS = 5
AGENT_LEARN_STEPS = 10
AGENT_EPISODE_STEPS = 8
LPIPS_COMPARED_FRAMES = 512
AGENT_DEPLOY_EPISODES = 3
ANALYSIS_RTOL = 1e-4
# train_muzero's module (the entry package binds the function's name), whose
# env factories phase 17 points at its stand-in
TRAIN_MUZERO_MODULE = importlib.import_module("lightzero_tpu_torch.entry.train_muzero")
# the RND entry's module, whose collector phase 17 cuts to RND_COLLECT_STEPS
RND_ENTRY_MODULE = importlib.import_module(
    "lightzero_tpu_torch.entry.train_muzero_with_reward_model")
# card vs CPU learn step from the same params and batch (TF32 off): the
# logged terms to 1e-4 relative (float32 matmuls of batch 256 summed in
# another order). Adam's first update is lr * g / (|g| + 1e-8), g the
# gradient it sees (clipped gradient + wd * p): where the card's and the
# CPU's g differ by d <= |g| / 100 the updates differ by at most lr / 400
# (the worst case is |g| = 1e-8), under 1e-5, so those params are held to
# 1e-5; where g is within 100 d of zero, rounding decides the update's
# sign, and those params are held to 2 lr (their count is reported and must
# be under a quarter of all)
LEARN_LOG_RTOL = 1e-4
LEARN_PARAM_ATOL = 1e-5
GRAD_TO_ROUNDING = 100.0

MAIN_SEED = 0
T_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's record gets ``t_s``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def _watchdog(signum, frame):
    print(f"chip_smoke: watchdog: the run did not finish within {WATCHDOG_S} s",
          file=sys.stderr, flush=True)
    os._exit(3)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = GRAPH_REPS, replays: int = 4) -> float:
    """Device time per call of fn(): CUDA events around replays of a CUDA
    graph that holds `reps` calls. The host's dispatch is left out, so for a
    small kernel this times the kernel and not the wrapper that launches it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


def phase_latency_probe(card: str) -> dict:
    """One dependent load that hits in L2, in ns: a single thread chases a
    random cycle through 4 MB (one int per 128-byte line), loads bypassing L1.
    And the floor of a launch: the same kernel with no loads, timed in a
    CUDA graph as the descent is."""
    steps = 20000
    stride, lines = 32, (4 << 20) // 128
    order = np.random.default_rng(0).permutation(lines)
    nxt = np.zeros(lines * stride, np.int32)
    nxt[order * stride] = np.roll(order, -1) * stride
    nxt = torch.from_numpy(nxt).cuda()
    out = torch.empty(1, dtype=torch.int32, device="cuda")

    def run(n):
        _build.launch("latency_probe_launch", nxt.device, nxt.data_ptr(), n, out.data_ptr())

    run(lines)  # brings the buffer into L2
    ms = cuda_ms(lambda: run(steps), reps=3, warmup=1)
    rec = dict(phase="latency_probe", l2_dependent_load_ns=ms * 1e6 / steps,
               empty_launch_ms=graph_ms(lambda: run(0)), card=card)
    emit(rec)
    return rec


def randomize_heads(model, seed: int) -> None:
    """Draw every head's last layer (zero at init, which would make each
    search a tie) from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    if isinstance(model, AlphaZeroModel):
        heads = tuple(model.mlp)  # policy, value
    elif isinstance(model, UniZeroModel):
        heads = [getattr(model, name) for name in (
            "value_head", "policy_head", "reward_head", "mu_head", "sigma_head")
            if hasattr(model, name)]
    elif isinstance(model, SampledHeads):
        # the value head, and whichever of the reward or value-prefix head and
        # the Gaussian or logits heads the model has
        heads = [getattr(model, name) for name in (
            "value_head", "reward_head", "value_prefix_head", "mu_head", "sigma_head",
            "policy_head") if hasattr(model, name)]
    elif isinstance(model, MuZeroRNNModel):
        heads = (model.reward_head, model.value_head, model.policy_head)
    elif getattr(model, "model_type", "mlp") == "conv":
        # the conv heads' MLPs: value, policy, and reward or value prefix
        first = (model.value_prefix_head if isinstance(model, EfficientZeroModel)
                 else model.dynamics_network.mlp[0])
        heads = (first, *model.prediction_network.mlp)
    else:
        if isinstance(model, EfficientZeroModel):
            first = model.value_prefix_head
        elif isinstance(model, StochasticMuZeroModel):
            first = model.reward_head
        else:
            first = model.dynamics_network.reward_head
        heads = (first, model.prediction_network.value_head, model.prediction_network.policy_head)
    if isinstance(model, StochasticMuZeroModel):
        heads += (model.afterstate_prediction_network.value_head,
                  model.afterstate_prediction_network.policy_head)
    for head in heads:
        w = head.dense[-1].weight
        w.data.copy_(lecun_normal_(torch.empty(w.shape), g))


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip().splitlines()[0]
    print(out, flush=True)
    return out


def warm_profiler() -> float:
    """Start and stop torch.profiler's device tracing once on a trivial
    op, creating the CUDA context on the way: phase 5's profiler pass,
    start to parse, took 16.3 s on an H100 host when it was the first,
    for a search of 0.38 s. Returns the seconds."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_build() -> dict:
    """Every source at once, one compiler each (nvcc for the kernels, g++
    for the replay buffer's core); the profiler is warmed up meanwhile."""
    sources = ["fused_traverse", "fused_backup", "channel_norm", "latency_probe", "replay_core"]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        # map submits every compile before it returns
        compiled = pool.map(_build.compile_library, sources)
        profiler_warmup_s = warm_profiler()
        paths = dict(zip(sources, compiled))
    for name in sources:
        _build.load(name)
    seconds = time.perf_counter() - t0
    output = {}
    for name, path in paths.items():
        log_path = path[: -len(".so")] + ".log"
        log = open(log_path).read() if os.path.exists(log_path) else ""
        output[name] = [line for line in log.splitlines()
                        if "registers" in line or "spill" in line]
    rec = dict(phase="build", seconds=seconds, nvcc_seconds=_build.build_seconds,
               profiler_warmup_s=profiler_warmup_s,
               libraries={k: os.path.relpath(v) for k, v in paths.items()},
               compiler_output=output)
    emit(rec)
    return rec


def traverse_case(B: int, A: int, N: int, first: bool, l2_ns: float, seed: int = 0,
                  inputs=None, label: str = "synthetic") -> dict:
    """The kernel and its plain version on the card on the same inputs:
    check_inputs' random trees from `seed`, or `inputs` (tensors on the card)."""
    if inputs is None:
        d = check_inputs(np.random.default_rng(seed), B, A, N, with_noise=not first)
        inputs = [None if d[k] is None else torch.from_numpy(d[k]).cuda()
                  for k in ("packed", "vmin", "vmax", "root_stats", "noise_u")]
    args = inputs
    kw = dict(A=A, N=N, max_depth=N + 1, discount=0.997, pb_c_base=19652.0, pb_c_init=1.25,
              value_delta_max=0.01, tie_break_first=first, tie_break_epsilon=1e-6)
    got = fused_traverse(*args, **kw)
    exp = fused_traverse_reference(*args, **kw)
    torch.cuda.synchronize()
    exact = [got[0][:, :5], got[1], got[2]], [exp[0][:, :5], exp[1], exp[2]]
    mismatches = sum(int((g != e).sum()) for g, e in zip(*exact))
    mismatches += sum(
        int((~torch.isclose(g, e, rtol=STATS_RTOL, atol=STATS_ATOL)).sum())
        for g, e in zip(got[3:], exp[3:])
    )
    max_abs_err = max(float((g - e).abs().max()) for g, e in zip(got, exp))
    ms = graph_ms(lambda: fused_traverse(*args, **kw))
    # launch to launch through the Python wrapper, host dispatch included: at a
    # small batch this is the wrapper's host time
    wrapper_ms = cuda_ms(lambda: fused_traverse(*args, **kw), reps=200)
    # one call: the plain call above is its warm-up, and the plain version is
    # host-bound at 50-150 ms a call (4 calls until phase 17 came)
    plain_ms = cuda_ms(lambda: fused_traverse_reference(*args, **kw), reps=1, warmup=0)

    # the least the card could take, as the benchmark counts it
    depth = exp[0][:, 3].double()
    deepest = int(depth.max())
    bytes_moved, ops = descent_bytes_ops(float(depth.sum()), B, A, N, first)
    bound_s = max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
    rec = dict(
        phase="kernel_vs_plain", kernel="fused_traverse", tables=label, B=B, A=A, N=N,
        tie_break="first" if first else "noise", route=kernel_route(A), mismatches=mismatches,
        max_abs_err=max_abs_err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
        bound_ms=bound_s * 1e3,
        bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S else "operations",
        bytes=bytes_moved, ops=ops, max_depth_reached=deepest,
        mean_depth=float(depth.mean()), us_per_level=ms * 1e3 / (deepest + 1),
        # a latency figure, not a bound: the deepest tree's chain of
        # dependent row reads at one L2 round trip each
        latency_ms=(deepest + 1) * l2_ns * 1e-6,
    )
    emit(rec)
    return rec


def phase_kernel_vs_plain(l2_ns: float) -> list:
    cases = []
    for i, (B, A, N) in enumerate(SYNTHETIC_SHAPES):
        for first in (False, True):
            cases.append(traverse_case(B, A, N, first, l2_ns, seed=SYNTHETIC_SEED + i))
    # one shape on each route, with values at the edges of float32
    for i, (B, A, N) in enumerate(EDGE_SHAPES):
        for first in (False, True):
            cases.append(traverse_case(B, A, N, first, l2_ns, label="edge values",
                                       inputs=edge_inputs(B, A, N, first, seed=200 + i)))
    check_cases(cases)
    return cases


def captured_backups(name: str, sims: tuple) -> dict:
    """One run of CHECK_SEARCHES' search `name` on the card through the
    backup kernel, keeping the arguments of the backups of simulations
    `sims`, each tensor cloned."""
    seen = {}
    orig = puct._expand_and_backup

    def clone(x):
        return None if x is None else map_embedding(torch.clone, x)

    def capture(cfg, tree, st, sim, out, *args, **kwargs):
        if sim in sims:
            seen[sim] = (cfg, puct.Tree(*(clone(v) for v in tree)),
                         type(st)(*(clone(v) for v in st)), type(out)(*(clone(v) for v in out)),
                         args, kwargs)
        return orig(cfg, tree, st, sim, out, *args, **kwargs)

    search, args, kwargs = check_search(name, "cuda")
    # Gumbel's search calls the function it imported from puct
    puct._expand_and_backup = gumbel._expand_and_backup = capture
    try:
        search(*args, **kwargs)
    finally:
        puct._expand_and_backup = gumbel._expand_and_backup = orig
    torch.cuda.synchronize()
    return seen


def backup_case(name: str, sim: int, captured: tuple, timed: bool) -> dict:
    """The backup kernel and its plain version on the card on the same
    captured inputs, each on its own copy of the tree: every tree tensor and
    vmin, vmax compared bitwise. Timed: the kernel's device time from graph
    replays, launch to launch through the wrapper, the plain version, and
    the bound."""
    cfg, tree, st, out, args, kwargs = captured
    B, N, A = tree.num_trees, tree.num_nodes, tree.num_actions
    P = st.path.shape[1]

    def copy_of_tree():
        return puct.Tree(*(map_embedding(torch.clone, v) for v in tree))

    got = fused_backup(cfg, copy_of_tree(), st, sim, out, *args, **kwargs)
    exp = fused_backup_reference(cfg, copy_of_tree(), st, sim, out, *args, **kwargs)
    torch.cuda.synchronize()
    mismatches = 0
    for field in puct.Tree._fields:
        pairs = []
        map_embedding(lambda g, e: pairs.append((g, e)), getattr(got, field), getattr(exp, field))
        mismatches += sum(int((g != e).sum()) for g, e in pairs)
    rec = dict(phase="backup_vs_plain", kernel="fused_backup", search=name, simulation=sim,
               B=B, A=A, N=N, P=P, mismatches=mismatches)
    if timed:
        scratch = copy_of_tree()
        rec["ms"] = graph_ms(lambda: fused_backup(cfg, scratch, st, sim, out, *args, **kwargs))
        rec["wrapper_ms"] = cuda_ms(
            lambda: fused_backup(cfg, scratch, st, sim, out, *args, **kwargs), reps=200)
        rec["plain_ms"] = cuda_ms(
            lambda: fused_backup_reference(cfg, scratch, st, sim, out, *args, **kwargs), reps=20)
        # the least the card could take: each input byte read once and each
        # output byte written once. Per tree: the slots of the path tables
        # that the kernel reads (int64 node, three f32 stats; slots 0 to the
        # descent's depth, whole 32-byte sectors), the descent's scalars, the
        # leaf's outputs, the two MinMax stats in and out; per expanding tree
        # the new row (prior, legal, four scalars, the child link) and its
        # embedding row read and written; per path node its value sum and
        # visit count read and written
        expand = ~st.leaf_is_terminal_node
        n_expand = int(expand.sum())
        path_nodes = int((st.depth + 1 + expand.long()).sum())
        emb = tree.embedding
        row_bytes = (emb[0, 0].numel() * emb.element_size()
                     if isinstance(emb, torch.Tensor) else 0)

        def path_sectors(elt: int) -> int:
            first = torch.arange(B, device=st.depth.device) * (P * elt)
            last = first + (st.depth + 1) * elt - 1
            return int((last // 32 - first // 32 + 1).sum()) * 32

        bytes_moved = (path_sectors(8) + 3 * path_sectors(4) + B * (3 * 8 + 4 + 1)
                       + B * (2 * 4 + A * 4) + B * 16
                       + n_expand * (A * 5 + 4 * 3 + 1 + 4 + 2 * row_bytes) + path_nodes * 16)
        # per tree: the doubling rounds (3 operations a slot a round), the
        # softmax (max, exp, sum, divide a row entry), and the contribution,
        # node value and q of every path node
        rounds = max(1, math.ceil(math.log2(P)))
        ops = B * (3 * P * rounds + 4 * A) + 8 * path_nodes
        bound_s = max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
        rec.update(bound_ms=bound_s * 1e3, bytes=bytes_moved, ops=ops,
                   bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S
                   else "operations", expanding_trees=n_expand)
    emit(rec)
    return rec


def phase_backup_vs_plain() -> list:
    """The backup kernel against its plain version on captured inputs: the
    search cell's shape (B=2,048, A=6, 6x6x64 embeddings) at
    BACKUP_CELL_SIMS, timed; one simulation of every other CHECK_SEARCHES
    search (terminal stops, A=18, A=37, and each of the kernel's options)."""
    cases = []
    for name, *_ in CHECK_SEARCHES:
        sims = BACKUP_CELL_SIMS if name == "cell" else (BACKUP_OTHER_SIM,)
        for sim, captured in sorted(captured_backups(name, sims).items()):
            cases.append(backup_case(name, sim, captured, timed=name == "cell"))
    bad = [c for c in cases if c["mismatches"]]
    if bad or len(cases) != len(BACKUP_CELL_SIMS) + len(CHECK_SEARCHES) - 1:
        raise AssertionError(f"fused_backup disagrees with its plain version: {bad or cases}")
    return cases


def scaled_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def channel_norm_case(label: str, shape: tuple, residual: bool) -> dict:
    """The channel-norm kernel pair against its plain version on seeded
    inputs: the output bitwise aten's (``y_mismatches``), the gradients
    against the plain backward formula in float64 given the kernel's output
    and statistics (the residual's gradient bitwise). Timed: the
    forward as the search runs it (no statistics saved) and the backward
    kernel pair, each from graph replays; the forward launch to launch
    through the wrapper; the plain version (F.layer_norm, the add, relu) and
    F.layer_norm + relu alone (``library_ms``); the plain backward through
    autograd; each bound: its compulsory bytes over the HBM rate."""
    g = torch.Generator(device="cuda").manual_seed(0)
    C = shape[-1]
    x = torch.randn(shape, generator=g, device="cuda") * 2.0 + 0.5
    res = torch.randn(shape, generator=g, device="cuda") if residual else None
    dy = torch.randn(shape, generator=g, device="cuda")
    norm = torch.nn.LayerNorm(C, eps=LAYER_NORM_EPS).cuda()
    with torch.no_grad():
        norm.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g, device="cuda"))
        norm.bias.copy_(0.1 * torch.randn(C, generator=g, device="cuda"))
    rows = x.numel() // C
    rec = dict(phase="channel_norm", kernel="channel_norm", label=label, shape=list(shape),
               residual=residual)
    w, b = norm.weight.detach(), norm.bias.detach()
    f64 = torch.float64
    with torch.no_grad():
        plain = cn.channel_norm_reference(x, norm, res)
        y, _, stats = cn._forward(x, w, b, res, norm.eps, save=True)
        dx, dw, db, dres = cn._backward(dy, x, y, stats, w, residual)
        mean, rstd = (t.reshape(shape[:-1]).to(f64) for t in stats)
        want = cn.channel_norm_backward_reference(dy.to(f64), x.to(f64), y.to(f64), mean, rstd,
                                                  w.to(f64))
    rec["gaps"] = dict(dx=scaled_gap(dx, want[0]), dw=scaled_gap(dw, want[1]),
                       db=scaled_gap(db, want[2]))
    rec["y_mismatches"] = int((y != plain).sum())
    rec["dres_equal"] = (not residual) or bool(torch.equal(dres, want[3].float()))
    del plain, dx, dw, db, dres, want
    with torch.no_grad():
        rec["ms"] = graph_ms(lambda: cn.channel_norm(x, norm, res), reps=10)
        rec["wrapper_ms"] = cuda_ms(lambda: cn.channel_norm(x, norm, res), reps=50)
        rec["plain_ms"] = graph_ms(lambda: cn.channel_norm_reference(x, norm, res), reps=10)
        rec["library_ms"] = graph_ms(
            lambda: torch.relu(torch.nn.functional.layer_norm(x, (C,), w, b, norm.eps)), reps=10)
        y, _, stats = cn._forward(x, w, b, res, norm.eps, save=True)
        rec["backward_ms"] = graph_ms(lambda: cn._backward(dy, x, y, stats, w, residual),
                                      reps=10)
    xi = x.clone().requires_grad_()
    ri = res.clone().requires_grad_() if residual else None
    yr = cn.channel_norm_reference(xi, norm, ri)
    leaves = [xi, norm.weight, norm.bias] + ([ri] if residual else [])
    rec["plain_backward_ms"] = cuda_ms(
        lambda: torch.autograd.grad(yr, leaves, dy, retain_graph=True), reps=10)
    fwd_bytes = 4 * (rows * C * (3 if residual else 2) + 2 * C)
    bwd_bytes = 4 * (rows * C * (5 if residual else 4) + 3 * C)
    rec.update(bytes=fwd_bytes, backward_bytes=bwd_bytes,
               bound_ms=fwd_bytes / HBM_BYTES_PER_S * 1e3,
               backward_bound_ms=bwd_bytes / HBM_BYTES_PER_S * 1e3,
               l2_resident=fwd_bytes < L2_BYTES)
    rec["roofline_pct"] = 100.0 * rec["bound_ms"] / rec["ms"]
    rec["backward_roofline_pct"] = 100.0 * rec["backward_bound_ms"] / rec["backward_ms"]
    emit(rec)
    del x, res, dy, xi, ri, yr, y, stats
    torch.cuda.empty_cache()
    return rec


def phase_channel_norm() -> list:
    """The channel-norm kernel pair against its plain version at the
    benchmark cells' shapes (CHANNEL_NORM_SHAPES), timed beside its bound."""
    cases = [channel_norm_case(*case) for case in CHANNEL_NORM_SHAPES]
    bad = [c for c in cases if c["y_mismatches"] or not c["dres_equal"]
           or any(c["gaps"][k] > tol for k, tol in CHANNEL_NORM_TOL.items())]
    if bad:
        raise AssertionError(f"channel_norm disagrees with its plain version: {bad}")
    return cases


CONV_NETWORKS = (RepresentationNetworkConv, DynamicsNetworkConv, PredictionNetworkConv)


def conv_norm_sites(net: torch.nn.Module) -> int:
    """A conv network's channel-norm sites: its nn.LayerNorm modules outside
    the heads' MLPs, each run once a forward through channel_norm."""
    in_mlp = {id(m) for sub in net.modules() if isinstance(sub, MLPTorso) for m in sub.modules()}
    return sum(isinstance(m, torch.nn.LayerNorm) and id(m) not in in_mlp for m in net.modules())


@contextlib.contextmanager
def counted_norm_launches(device: str = "cuda"):
    """channel_norm's launch counter zeroed, and the launches that the conv
    networks' calls on ``device`` should make counted beside it: one a site
    for the forward, two more for the backward where the call's output
    carries a gradient (every such output reaches the loss). Yields a dict
    whose "launches" and "expected" are final on exit."""
    counts = dict(expected=0, launches=None)

    def hook(module, args, output):
        if isinstance(module, CONV_NETWORKS) and next(module.parameters()).device.type == device:
            outs = output if isinstance(output, tuple) else (output,)
            grad = any(isinstance(t, torch.Tensor) and t.requires_grad for t in outs)
            counts["expected"] += conv_norm_sites(module) * (3 if grad else 1)

    for entry in ("channel_norm_forward", "channel_norm_backward"):
        _build.launches[entry] = 0
    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield counts
    finally:
        handle.remove()
        # the backward's entry point launches two kernels
        counts["launches"] = (_build.launches["channel_norm_forward"]
                              + 2 * _build.launches["channel_norm_backward"])


def check_norm_launches(counts: dict, what: str) -> None:
    if counts["launches"] != counts["expected"] or not counts["expected"]:
        raise AssertionError(f"{what}: channel_norm launched {counts['launches']} times, the "
                             f"conv networks' sites x calls give {counts['expected']}")


def phase_captured(captures: dict, l2_ns: float, search: str = "bench search") -> list:
    """Phase 3 on the descent's inputs captured from a search, under both
    tie-breaks (the 'noise' uniforms drawn from a seed)."""
    cases = []
    for sim, (inputs, (B, A, N)) in sorted(captures.items()):
        noise = torch.from_numpy(
            np.random.default_rng(sim).random((N + 1, B, A)).astype(np.float32)).cuda()
        for first in (False, True):
            args = list(inputs[:4]) + [None if first else noise]
            cases.append(traverse_case(B, A, N, first, l2_ns, inputs=args,
                                       label=f"{search}, simulation {sim}"))
    check_cases(cases)
    return cases


def edge_inputs(B: int, A: int, N: int, first: bool, seed: int) -> list:
    """check_inputs' trees with values at the edges of float32: zero and
    negative-zero value sums, quotients far beyond 2^60, visit counts near
    the denormals, zero rewards and a value bound near 1e30. They send the
    kernel's fast division to its exact fallback."""
    rng = np.random.default_rng(seed)
    d = check_inputs(rng, B, A, N, with_noise=not first)
    pk = d["packed"]
    vsum = pk[:, :, 4 * A:5 * A]
    m = rng.random(vsum.shape)
    vsum[m < 0.1] = 0.0
    vsum[(m >= 0.1) & (m < 0.2)] = -0.0
    q = B // 8
    pk[q:2 * q, :, 4 * A:5 * A] *= np.float32(1e32)
    pk[2 * q:3 * q, :, 3 * A:4 * A] *= np.float32(1e-38)
    pk[3 * q:4 * q, :, 5 * A:6 * A] = 0.0
    d["vmin"][4 * q:5 * q] = 1e30
    d["vmax"][4 * q:5 * q] = 3e30
    return [None if d[k] is None else torch.from_numpy(d[k]).cuda()
            for k in ("packed", "vmin", "vmax", "root_stats", "noise_u")]


def midpoint_operands(rng, n: int) -> tuple:
    """n operand pairs whose quotient lies as close to a rounding midpoint
    as two 24-bit significands allow: A / B = M / 2^k - s / (B 2^k) with M
    odd, s = +-1, so M / 2^k is a midpoint of the quotient's binade, [1, 2)
    for k = 24 and [1/2, 1) for k = 25. Scaled to random exponents within
    2^+-60 and random signs, where the fast division takes every pair."""
    m = 4 * n
    B = 2 * rng.integers(1 << 22, 1 << 23, m, dtype=np.int64) + 1  # odd, in [2^23, 2^24)
    s = rng.choice(np.array([-1, 1], np.int64), m)
    k = np.where(rng.random(m) < 0.5, 24, 25).astype(np.int64)
    mod = np.left_shift(np.int64(1), k)
    inv = B.copy()  # B^-1 mod 2^k by Newton's iteration: 3, 6, 12, 24, 48 bits
    for _ in range(5):
        inv = inv * ((2 - B * inv) % mod) % mod
    M = (s * inv) % mod
    M = np.where(k == 24, M + mod, M)
    A = (M * B - s) >> k
    keep = np.flatnonzero((A >= 1 << 23) & (A < 1 << 24))[:n]
    if keep.size < n:
        raise AssertionError(f"only {keep.size} of {n} midpoint pairs drawn")

    def scaled(x):
        e = rng.integers(-60, 60, n)
        sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        return (sign * np.ldexp(x[keep].astype(np.float64), e - 23)).astype(np.float32)

    return scaled(A), scaled(B)


def random_operands(rng, n: int) -> np.ndarray:
    """Operands over the whole float32 range, with zeros and special values."""
    mant = rng.random(n).astype(np.float32) + np.float32(1.0)
    x = np.ldexp(mant, rng.integers(-140, 127, n)).astype(np.float32)
    x[rng.random(n) < 0.5] *= -1
    special = rng.random(n)
    x[special < 0.01] = 0.0
    x[(special >= 0.01) & (special < 0.02)] = -0.0
    x[(special >= 0.02) & (special < 0.025)] = np.inf
    x[(special >= 0.025) & (special < 0.03)] = np.nan
    return x


def fast_division(a: np.ndarray, b: np.ndarray) -> tuple:
    """The kernel's fast division and '/' on the card: (fast, exact, taken
    as exact) as numpy arrays."""
    n = a.size
    a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    fast = torch.empty_like(a)
    exact = torch.empty_like(a)
    in_range = torch.empty(n, dtype=torch.int32, device="cuda")
    _build.launch("fused_traverse_check_div", a.device, a.data_ptr(), b.data_ptr(),
                  fast.data_ptr(), exact.data_ptr(), in_range.data_ptr(), n)
    torch.cuda.synchronize()
    return fast.cpu().numpy(), exact.cpu().numpy(), in_range.cpu().numpy().astype(bool)


def phase_division_check(card: str, n: int = 1 << 22) -> dict:
    """The kernel's branch-free division against '/' on the card: random
    operands over the whole float32 range, zeros and special values, where
    the two must agree bit for bit wherever the fast path takes a pair as
    exact; and quotients next to a rounding midpoint, which the fast path
    must take and round as '/' and numpy do."""
    rng = np.random.default_rng(5)
    bits = lambda x: x.view(np.int32)  # noqa: E731
    fast, exact, taken = fast_division(random_operands(rng, n), random_operands(rng, n))
    a, b = midpoint_operands(rng, n)
    mfast, mexact, mtaken = fast_division(a, b)
    rec = dict(phase="division_check", pairs=n, taken_as_exact=int(taken.sum()),
               mismatches=int(((bits(fast) != bits(exact)) & taken).sum()),
               midpoint_pairs=n, midpoint_taken_as_exact=int(mtaken.sum()),
               midpoint_mismatches=int((bits(mfast) != bits(mexact)).sum()),
               midpoint_mismatches_numpy=int((bits(mfast) != bits(a / b)).sum()),
               card=card)
    emit(rec)
    if (rec["mismatches"] or rec["midpoint_mismatches"] or rec["midpoint_mismatches_numpy"]
            or rec["midpoint_taken_as_exact"] != n):
        raise AssertionError(f"the kernel's fast division differs from '/': {rec}")
    return rec


def check_cases(cases: list) -> None:
    bad = [c for c in cases if c["mismatches"]]
    if bad:
        raise AssertionError(f"fused_traverse disagrees with its plain version: {bad}")


def check_backup_launches(rec: dict, sims: int, label: str) -> None:
    """A one-player float32 search on the card backs up through the backup
    kernel once a simulation: ``sims`` launches for each of the eval's
    searches, one an env step."""
    if rec["backup_launches"] != rec["env_steps"] * sims:
        raise AssertionError(f"{label}: backup launches {rec['backup_launches']} != env steps "
                             f"{rec['env_steps']} x {sims}")


def phase_main_path(card: str) -> dict:
    policy = MuZeroPolicy(main_config.policy, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 1)
    sims = policy.search_cfg.num_simulations
    rec = eval_episodes(policy, card, "main_path")
    rec.update(config="cartpole_muzero", num_simulations=sims)
    emit(rec)
    if rec["launches"] != rec["env_steps"] * sims:
        raise AssertionError(f"traverse launches {rec['launches']} != env steps "
                             f"{rec['env_steps']} x {sims}")
    check_backup_launches(rec, sims, "main path")
    search_card_vs_cpu(policy, "muzero")
    return rec


def device_busy(prof) -> dict:
    """Device time from a profiler trace: the union of the intervals of all
    device activity, the descent kernel's own time and count, and the device
    time by kernel name. The spans that user annotations (record_function,
    e.g. the optimizer's step) leave on the device timeline are not device
    work and are left out."""
    spans, kernel_us, kernel_n, by_name = [], 0.0, 0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        if "fused_traverse_kernel" in e.name:
            kernel_us += e.time_range.elapsed_us()
            kernel_n += 1
    busy_us, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(device_events=len(spans), busy_us=busy_us, kernel_us=kernel_us,
                kernel_launches=kernel_n, top=[(name[:80], us) for name, us in top])


def phase_bench_shape(card: str) -> tuple:
    t_phase = time.perf_counter()
    cfg = MuZeroPolicy.default_config()
    cfg.model.observation_shape = 8
    cfg.model.action_space_size = 4
    cfg.model.latent_state_dim = 128
    cfg.model.support_scale = 300
    cfg.num_simulations = 50
    sims = cfg.num_simulations
    policy = MuZeroPolicy(cfg, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 2)
    policy.search_cfg = dataclasses.replace(policy.search_cfg, tie_break="first")
    B, A = 1024, 4
    obs = torch.from_numpy(
        np.random.default_rng(MAIN_SEED).standard_normal((B, 8)).astype(np.float32)).cuda()
    legal = torch.ones((B, A), dtype=torch.bool, device="cuda")

    # warm-up (cuBLAS handles, caching allocator), keeping the descent's
    # inputs of some simulations
    captures = capture_descent_inputs(policy, obs, legal, CAPTURED_SIMS)
    setup_s = time.perf_counter() - t_phase

    walls = []
    for _ in range(BENCH_SEARCHES):
        t0 = time.perf_counter()
        with_kernel = policy.forward_eval(obs, legal)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    kernel_s = float(np.median(walls))

    puct.fused_traverse = fused_traverse_reference
    try:
        t0 = time.perf_counter()
        plain = policy.forward_eval(obs, legal)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        puct.fused_traverse = fused_traverse
    equal = torch.equal(with_kernel["visit_counts"], plain["visit_counts"])

    # one more search under the profiler: where the device time goes (the
    # device's events only: the host's op events took seconds to parse)
    from torch.profiler import ProfilerActivity, profile
    t_profile = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        policy.forward_eval(obs, legal)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    busy = device_busy(prof)
    profile_s = time.perf_counter() - t_profile
    measured = busy["device_events"] > 0
    rec = dict(phase="bench_shape", B=B, A=A, num_simulations=sims,
               search_s_kernel=kernel_s, search_s_kernel_all=walls, search_s_plain=plain_s,
               sims_per_s_kernel=B * sims / kernel_s, sims_per_s_plain=B * sims / plain_s,
               visit_counts_equal=equal,
               # the phase's own cost: policy and warm-up search, and the
               # profiled search with the profiler's start, stop and parse
               setup_s=setup_s, profile_s=profile_s,
               profiled_search_s=profiled_s, profiler_device_events=busy["device_events"],
               device_busy_ms=busy["busy_us"] / 1e3 if measured else None,
               # busy share of the profiled search's wall, and of the median
               # unprofiled wall (the profiler slows the host, not the device)
               busy_share_profiled=busy["busy_us"] / 1e6 / profiled_s if measured else None,
               busy_share=busy["busy_us"] / 1e6 / kernel_s if measured else None,
               kernel_us_per_sim=busy["kernel_us"] / sims if measured else None,
               kernel_launches_profiled=busy["kernel_launches"],
               # device time per simulation of the kernels that take the most
               top_device_us_per_sim=[(name, us / sims) for name, us in busy["top"]],
               card=card)
    emit(rec)
    if not equal:
        diff = (with_kernel["visit_counts"] != plain["visit_counts"]).any(dim=1).sum().item()
        raise AssertionError(f"kernel and plain searches differ in {diff} of {B} trees")
    if sorted(captures) != list(CAPTURED_SIMS):
        raise AssertionError(f"captured simulations {sorted(captures)}, expected {CAPTURED_SIMS}")
    return rec, captures


def capture_descent_inputs(policy, obs, legal, sims: tuple) -> dict:
    """One eval search through the policy, keeping the descent's inputs of
    the simulations in ``sims``: {sim: (inputs, (B, A, N))}."""
    captures, calls = {}, []

    def capturing(packed, vmin, vmax, root_stats, noise_u, **kw):
        sim = len(calls) + 1
        calls.append(sim)
        if sim in sims:
            captures[sim] = ([x.clone() for x in (packed, vmin, vmax, root_stats)],
                             (packed.shape[0], kw["A"], kw["N"]))
        return fused_traverse(packed, vmin, vmax, root_stats, noise_u, **kw)

    puct.fused_traverse = capturing
    try:
        policy.forward_eval(obs, legal)
    finally:
        puct.fused_traverse = fused_traverse
    torch.cuda.synchronize()
    return captures


def batch_to(batch, device):
    """A batch (a NamedTuple of tensors, or of such batches) on ``device``."""
    return type(batch)(*(None if x is None else x.to(device) if torch.is_tensor(x)
                         else batch_to(x, device) for x in batch))


def compare_learn_steps(card: dict, cpu: dict) -> tuple:
    """Card against CPU after one Adam step from the same params: the logs'
    relative errors, and the params' largest error where the gradient Adam
    saw (``g``) is more than GRAD_TO_ROUNDING times the two devices'
    rounding of it, and where it is not, with the count of the latter:
    (log errors, tight error, loose error, loose elements, elements)."""
    log_err = {k: abs(card["logs"][k] - v) / max(abs(v), 1e-6) for k, v in cpu["logs"].items()}
    tight_err, loose_err, loose, total = 0.0, 0.0, 0, 0
    for name, exp in cpu["params"].items():
        err = (card["params"][name] - exp).abs()
        rounding = (card["g"][name] - cpu["g"][name]).abs()
        sensitive = cpu["g"][name].abs() <= GRAD_TO_ROUNDING * rounding
        if (~sensitive).any():
            tight_err = max(tight_err, float(err[~sensitive].max()))
        if sensitive.any():
            loose_err = max(loose_err, float(err[sensitive].max()))
        loose += int(sensitive.sum())
        total += sensitive.numel()
    return log_err, tight_err, loose_err, loose, total


def h_inverse_step(value: torch.Tensor) -> torch.Tensor:
    """The float32 resolution of h^-1 at |value|. h^-1(v) = u^2 - 1 with
    u = (s - 1) / (2 eps) = sqrt(|v| + 1), s = sqrt(1 + 4 eps (|x| + 1 +
    eps)) = 1 + 2 eps u; one float32 step of s moves u by spacing(s) / (2
    eps), so h^-1 by u spacing(s) / eps: 1.19e-4 near 0, more than
    VALUE_TOL x (1 + |v|) for |v| < 0.42."""
    u = torch.sqrt(value.abs().double() + 1.0)
    spacing = torch.exp2(torch.floor(torch.log2(1.0 + 2.0 * H_EPS * u)) - 23.0)
    return (u * spacing / H_EPS).float()


def priority_err_over_bound(card_priority, cpu_priority, batch) -> float:
    """The largest card-vs-CPU priority error over its bound. A priority is
    |root value - target value|: it carries the root value's error, VALUE_TOL
    relative to the value (at most |target| + priority), not relative to the
    difference, in which the two values cancel, plus one float32 step of
    h^-1 at that value, the resolution at which the value is read."""
    base = getattr(batch, "base", batch)
    value = base.target_value[:, 0].abs().cpu() + cpu_priority.abs()
    bound = VALUE_TOL * (1.0 + value) + h_inverse_step(value)
    return float(((card_priority - cpu_priority).abs() / bound).max())


def learn_step_card_vs_cpu(policy, batch, log_atol=None) -> tuple:
    """One learn step on the card and one on the CPU, each from a fresh
    optimizer over the same params, on the same batch: (record, agree).
    The gradient Adam sees holds the decay term wd * p, except under AdamW,
    which decays after Adam's scaling. The logs named in ``log_atol`` are
    held to its absolute tolerances instead of LEARN_LOG_RTOL."""
    log_atol = log_atol or {}
    results = {}
    for dev in ("cuda", "cpu"):
        p = type(policy)(policy.cfg, model=copy.deepcopy(policy.model), device=dev)
        before = {k: v.detach().cpu().clone() for k, v in p.model.named_parameters()}
        state = p.init_train_state()
        wd = (0.0 if isinstance(state.optimizer, torch.optim.AdamW)
              else float(p.cfg.weight_decay))
        _, logs, priority = p.forward_learn(state, batch_to(batch, p.device))
        g = {k: v.grad.cpu() + wd * before[k] for k, v in p.model.named_parameters()}
        results[dev] = dict(logs={k: float(v) for k, v in logs.items()}, priority=priority.cpu(),
                            params={k: v.detach().cpu() for k, v in p.model.named_parameters()},
                            g=g)
    card, cpu = results["cuda"], results["cpu"]
    lr = float(policy.cfg.learning_rate)
    log_err, tight_err, loose_err, loose, total = compare_learn_steps(card, cpu)
    priority_ratio = priority_err_over_bound(card["priority"], cpu["priority"], batch)
    abs_err = {k: abs(card["logs"][k] - cpu["logs"][k]) for k in log_atol}
    log_err = {k: v for k, v in log_err.items() if k not in log_atol}
    rec = dict(phase="train_card_vs_cpu", batch=int(cpu["priority"].shape[0]),
               max_log_rel_err=max(log_err.values()), log_rel_err=log_err,
               log_abs_err=abs_err, log_abs_values={k: card["logs"][k] for k in log_atol},
               priority_max_abs_err=float((card["priority"] - cpu["priority"]).abs().max()),
               priority_err_over_bound=priority_ratio,
               param_max_abs_err=tight_err, param_max_abs_err_rounding_bound=loose_err,
               rounding_bound_elements=loose, elements=total,
               total_loss_card=card["logs"]["total_loss"], total_loss_cpu=cpu["logs"]["total_loss"])
    emit(rec)
    agree = (rec["max_log_rel_err"] <= LEARN_LOG_RTOL and tight_err <= LEARN_PARAM_ATOL
             and loose_err <= 2 * lr and priority_ratio <= 1.0 and loose < total // 4
             and all(abs_err[k] <= tol for k, tol in log_atol.items()))
    return rec, agree


def time_learn_steps(policy, state, buffer, n: int) -> tuple:
    """CUDA events around each of n learn steps on fresh samples:
    (state, step ms, sample s, losses)."""
    batch_size = int(policy.cfg.batch_size)
    step_ms, sample_s, losses = [], [], []
    for _ in range(n):
        t1 = time.perf_counter()
        batch, idx = buffer.sample(batch_size, state.target_model)
        sample_s.append(time.perf_counter() - t1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, logs, priority = policy.forward_learn(state, batch)
        end.record()
        buffer.update_priority(idx, priority.cpu().numpy())
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(logs["total_loss"]))
    return state, step_ms, sample_s, losses


def phase_train(card: str) -> dict:
    """The CartPole config at full width through train_muzero on the card:
    TRAIN_ITERS learn steps after the collect rounds they need, an eval at
    iter 0, with the launch counter read around the call."""
    cfg = copy.deepcopy(main_config)
    sims = cfg.policy.num_simulations
    n_envs = cfg.env.collector_env_num
    with tempfile.TemporaryDirectory() as tmp:
        cfg.exp_name = os.path.join(tmp, "cartpole_muzero")
        _build.launches[DESCENT] = 0
        t0 = time.perf_counter()
        policy, state, stats = train_muzero(cfg, seed=MAIN_SEED, device="cuda",
                                            max_train_iter=TRAIN_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _build.launches[DESCENT]
        with open(os.path.join(cfg.exp_name, "log", "train.jsonl")) as f:
            records = [json.loads(line) for line in f]
    trained_iter = state.train_iter
    losses = [r["learner/total_loss"] for r in records if "learner/total_loss" in r]
    collect_sps = [r["collector/steps_per_sec"] for r in records if "collector/steps_per_sec" in r]
    evals = [r["evaluator/eval_mean_return"] for r in records if "evaluator/eval_mean_return" in r]
    collect_searches = stats["env_steps"] // n_envs
    expected = (collect_searches + stats["eval_env_steps"]) * sims
    params_finite = all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
    target_is_online = all(torch.equal(a, b) for a, b in zip(
        state.model.state_dict().values(), state.target_model.state_dict().values()))
    buffer = stats["buffer"]
    batch_size = int(policy.cfg.batch_size)

    # card vs CPU, on a batch of this run's buffer
    batch, _ = buffer.sample(batch_size, state.target_model)
    agreement, agree = learn_step_card_vs_cpu(policy, batch)

    # one sample with reanalyze: one search over its roots
    buffer.reanalyze_ratio = 0.25
    before = _build.launches[DESCENT]
    buffer.sample(batch_size, state.target_model)
    torch.cuda.synchronize()
    reanalyze_launches = _build.launches[DESCENT] - before
    buffer.reanalyze_ratio = 0.0

    state, step_ms, sample_s, timed_losses = time_learn_steps(
        policy, state, buffer, TIMED_LEARN_STEPS)

    from torch.profiler import ProfilerActivity, profile
    batches = [buffer.sample(batch_size, state.target_model)[0] for _ in range(PROFILED_LEARN_STEPS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for batch in batches:
            state, logs, _ = policy.forward_learn(state, batch)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t1
    busy = device_busy(prof)
    measured = busy["device_events"] > 0
    rec = dict(
        phase="train", config="cartpole_muzero", batch_size=batch_size, num_simulations=sims,
        collect_envs=n_envs, train_iter=stats["train_iter"], state_train_iter=trained_iter,
        env_steps=stats["env_steps"], collect_searches=collect_searches,
        eval_searches=stats["eval_env_steps"], launches=launches, expected_launches=expected,
        logged_total_losses=losses, eval_mean_returns=evals, collect_steps_per_s=collect_sps,
        params_finite=params_finite, target_is_online=target_is_online,
        reanalyze_launches=reanalyze_launches, wall_s=wall,
        learn_step_ms_median=float(np.median(step_ms)), learn_step_ms=step_ms,
        sample_ms_median=float(np.median(sample_s)) * 1e3, timed_losses=timed_losses,
        profiled_steps=PROFILED_LEARN_STEPS, profiled_s=profiled_s,
        device_busy_ms=busy["busy_us"] / 1e3 if measured else None,
        busy_share_profiled=busy["busy_us"] / 1e6 / profiled_s if measured else None,
        top_device_us_per_step=[(name, us / PROFILED_LEARN_STEPS) for name, us in busy["top"]],
        card=card,
    )
    emit(rec)
    problems = [] if agree else [f"card and CPU learn steps disagree: {agreement}"]
    if stats["train_iter"] != TRAIN_ITERS or trained_iter != TRAIN_ITERS:
        problems.append(f"train_iter {stats['train_iter']} (state {trained_iter}), expected {TRAIN_ITERS}")
    if not losses or not all(math.isfinite(x) for x in losses + timed_losses) or not params_finite:
        problems.append("non-finite loss or params")
    if not target_is_online:
        problems.append(f"the target net differs from the online net after the copy at iter {TRAIN_ITERS}")
    if launches != expected:
        problems.append(f"traverse launches {launches} != (collect + eval searches) x {sims}")
    if reanalyze_launches != sims:
        problems.append(f"a reanalyze sample launched {reanalyze_launches}, expected {sims}")
    if problems:
        raise AssertionError(f"train phase failed: {problems}")
    rec["card_vs_cpu"] = agreement
    return rec


def eval_episodes(policy, card: str, label: str, env=None, returns_range=(0, math.inf)) -> dict:
    """The Evaluator on 3 envs (CartPole unless ``env`` is given) until each
    ends an episode, the descent's and the backup's launch counters read
    around it; each return must be finite and within ``returns_range``
    (CartPole's: 1 to 200)."""
    cartpole = env is None
    env = CartPoleEnv() if cartpole else env
    evaluator = Evaluator(env, policy, num_envs=3, seed=MAIN_SEED, device="cuda")
    _build.launches[DESCENT] = 0
    _build.launches[BACKUP] = 0
    t0 = time.perf_counter()
    result = evaluator.eval(max_steps=200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps, returns = result["env_steps"], result["episode_returns"]
    rec = dict(phase=f"{label}_eval", num_envs=3, episode_returns=returns, env_steps=steps,
               launches=_build.launches[DESCENT], backup_launches=_build.launches[BACKUP],
               wall_s=wall, wall_per_env_step_s=wall / steps, card=card)
    low, high = (1, 200) if cartpole else returns_range
    if len(returns) < 3 or not all(math.isfinite(r) and low <= r <= high for r in returns):
        raise AssertionError(f"{label}: implausible returns {returns}")
    return rec


def with_sims(config, sims: int):
    """A deep copy of a MuZero-family config whose searches run ``sims``
    simulations."""
    cfg = copy.deepcopy(config)
    cfg.policy.num_simulations = sims
    return cfg


def short_train(cfg, card: str, label: str, launches_per_search: int,
                extra_launches=lambda: 0, timed_steps: int = TIMED_LEARN_STEPS,
                halved_round: bool = True) -> tuple:
    """train_muzero with the device left unset (the card): an eval at iter
    0, one collect round (with ``halved_round``, SHORT_COLLECT_STEPS batched
    steps over twice the config's collect envs) and SHORT_TRAIN_ITERS learn
    steps, the launch counter read around it (``extra_launches()`` adds what
    the run launched outside its collect and eval searches); then one learn
    step on the card against one on the CPU, and the learn-step time.
    (record, problems, policy, state, buffer)"""
    cfg = copy.deepcopy(cfg)
    cfg.policy.update_per_collect = SHORT_TRAIN_ITERS
    if halved_round:
        cfg.env.collector_env_num *= 2
        TRAIN_MUZERO_MODULE.RolloutCollector = functools.partial(
            RolloutCollector, rollout_length=SHORT_COLLECT_STEPS)
    n_envs = cfg.env.collector_env_num
    with tempfile.TemporaryDirectory() as tmp:
        cfg.exp_name = os.path.join(tmp, label)
        _build.launches[DESCENT] = 0
        t0 = time.perf_counter()
        try:
            policy, state, stats = train_muzero(cfg, seed=MAIN_SEED,
                                                max_train_iter=SHORT_TRAIN_ITERS)
        finally:
            TRAIN_MUZERO_MODULE.RolloutCollector = RolloutCollector
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _build.launches[DESCENT]
        with open(os.path.join(cfg.exp_name, "log", "train.jsonl")) as f:
            records = [json.loads(line) for line in f]
        with open(os.path.join(cfg.exp_name, "log", "train.txt")) as f:
            reanalyzed = [int(n) for n in re.findall(r"rezero: reanalyzed (\d+) transitions",
                                                     f.read())]
    losses = [r["learner/total_loss"] for r in records if "learner/total_loss" in r]
    collect_sps = [r["collector/steps_per_sec"] for r in records if "collector/steps_per_sec" in r]
    collect_searches = stats["env_steps"] // n_envs
    expected = (collect_searches + stats["eval_env_steps"]) * launches_per_search + extra_launches()
    buffer = stats["buffer"]
    batch, _ = buffer.sample(int(policy.cfg.batch_size), state.target_model)
    agreement, agree = learn_step_card_vs_cpu(policy, batch)
    state, step_ms, _, timed_losses = time_learn_steps(policy, state, buffer, timed_steps)
    params_finite = all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
    rec = dict(phase=f"{label}_train", train_iter=stats["train_iter"], env_steps=stats["env_steps"],
               collect_searches=collect_searches, eval_searches=stats["eval_env_steps"],
               num_simulations=int(cfg.policy.num_simulations), collect_envs=n_envs,
               launches=launches, expected_launches=expected, logged_total_losses=losses,
               logged_reanalyzed=reanalyzed,
               collect_steps_per_s=collect_sps, wall_s=wall,
               learn_step_ms_median=float(np.median(step_ms)), learn_step_ms=step_ms,
               card_vs_cpu=agreement, card=card)
    problems = [] if agree else [f"card and CPU learn steps disagree: {agreement}"]
    if stats["train_iter"] != SHORT_TRAIN_ITERS:
        problems.append(f"train_iter {stats['train_iter']}, expected {SHORT_TRAIN_ITERS}")
    if not losses or not all(math.isfinite(x) for x in losses + timed_losses) or not params_finite:
        problems.append("non-finite loss or params")
    if launches != expected:
        problems.append(f"traverse launches {launches} != (collect + eval searches) x "
                        f"{launches_per_search} + {extra_launches()}")
    return rec, problems, policy, state, buffer


def phase_efficientzero(card: str, l2_ns: float) -> tuple:
    """EfficientZero on CartPole at full width; its search is the pUCT
    search, through the descent kernel."""
    policy = EfficientZeroPolicy(ez_config.policy, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 3)
    sims = policy.search_cfg.num_simulations
    ev = eval_episodes(policy, card, "efficientzero")
    emit(ev)
    if ev["launches"] != ev["env_steps"] * sims:
        raise AssertionError(f"efficientzero: traverse launches {ev['launches']} != env steps "
                             f"{ev['env_steps']} x {sims}")
    check_backup_launches(ev, sims, "efficientzero")
    agreement = search_card_vs_cpu(policy, "efficientzero")

    obs = torch.from_numpy(
        (np.random.default_rng(MAIN_SEED + 3).standard_normal((3, 4)) * 0.1).astype(np.float32))
    legal = torch.ones((3, 2), dtype=torch.bool)
    captures = capture_descent_inputs(policy, obs.cuda(), legal.cuda(), EZ_CAPTURED_SIMS)
    if sorted(captures) != list(EZ_CAPTURED_SIMS):
        raise AssertionError(f"captured simulations {sorted(captures)}, expected {EZ_CAPTURED_SIMS}")
    cases = phase_captured(captures, l2_ns, search="efficientzero eval search")

    train, problems, *_ = short_train(with_sims(ez_config, SHORT_TRAIN_SIMS), card,
                                      "efficientzero", SHORT_TRAIN_SIMS)
    emit(train)
    if problems:
        raise AssertionError(f"efficientzero train failed: {problems}")
    return dict(eval=ev, card_vs_cpu=agreement, train=train), cases


def search_card_vs_cpu(policy, label: str, gumbel_table=None) -> dict:
    """A batch of 4 searched on the card and on the CPU from the same
    weights (the CPU's plain descent and search are held against the JAX
    package by the tests): actions and root visit counts equal, values and
    the improved policy within VALUE_TOL."""
    obs = torch.from_numpy(
        (np.random.default_rng(MAIN_SEED).standard_normal((4, 4)) * 0.1).astype(np.float32))
    legal = torch.ones((4, 2), dtype=torch.bool)
    to_play = torch.full((4,), -1, dtype=torch.int32)
    cpu_policy = type(policy)(policy.cfg, model=copy.deepcopy(policy.model).cpu(), device="cpu")
    extra = {} if gumbel_table is None else dict(gumbel=gumbel_table)
    outs = [p._forward_collect(obs.to(p.device), legal.to(p.device), to_play.to(p.device), 1.0,
                               0.0, deterministic=True,
                               **{k: v.to(p.device) for k, v in extra.items()})
            for p in (policy, cpu_policy)]
    on_card, on_cpu = ({k: v.cpu() for k, v in o.items()} for o in outs)
    counts = "raw_visit_counts" if "raw_visit_counts" in on_cpu else "visit_counts"
    for key in ("action", counts):
        if not torch.equal(on_card[key], on_cpu[key]):
            raise AssertionError(f"{label}: card and CPU searches differ in {key}: "
                                 f"{on_card[key].tolist()} vs {on_cpu[key].tolist()}")
    close = ["searched_value", "predicted_value"] + (["visit_counts"] if extra else [])
    err = {}
    for key in close:
        a, b = on_card[key].float(), on_cpu[key].float()
        err[key] = float((a - b).abs().max())
        if not (torch.isfinite(a).all() and torch.allclose(a, b, rtol=VALUE_TOL, atol=VALUE_TOL)):
            raise AssertionError(f"{label}: card and CPU {key} differ: {a.tolist()} vs {b.tolist()}")
    rec = dict(phase=f"{label}_card_vs_cpu", batch=4, visit_counts=on_card[counts].tolist(),
               searched_value=on_card["searched_value"].tolist(), max_abs_err=err)
    emit(rec)
    return rec


def phase_gumbel(card: str) -> dict:
    """Gumbel MuZero on CartPole: collect and eval search with the Gumbel
    search (plain PyTorch, no kernel); reanalyze with the pUCT search."""
    policy = GumbelMuZeroPolicy(gumbel_config.policy, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 4)
    sims = policy.gumbel_cfg.num_simulations

    ev = eval_episodes(policy, card, "gumbel_muzero",
                       env=CartPoleEnv(max_episode_steps=GUMBEL_EVAL_STEPS),
                       returns_range=(1, GUMBEL_EVAL_STEPS))
    emit(ev)
    if ev["launches"] != 0:
        raise AssertionError(f"gumbel_muzero: the eval launched the pUCT kernel {ev['launches']} times")
    # Gumbel's search expands and backs up through puct's _expand_and_backup
    check_backup_launches(ev, sims, "gumbel_muzero")

    # a second eval, every descent timed on the host between two device
    # syncs (the descent reads back a flag per level): the descent's share
    # of this instrumented wall; the first eval's wall has no added sync
    descent, restore = timed_descents(gumbel, "_gumbel_traverse")
    try:
        timed = eval_episodes(policy, card, "gumbel_muzero_descent_timed",
                              env=CartPoleEnv(max_episode_steps=GUMBEL_EVAL_STEPS),
                              returns_range=(1, GUMBEL_EVAL_STEPS))
    finally:
        restore()
    emit(descent_record(timed, descent))
    if descent["calls"] != timed["env_steps"] * sims:
        raise AssertionError(f"gumbel_muzero: {descent['calls']} descents for "
                             f"{timed['env_steps']} searches x {sims}")
    table = torch.from_numpy(
        np.random.default_rng(MAIN_SEED + 4).gumbel(size=(4, 2)).astype(np.float32))
    agreement = search_card_vs_cpu(policy, "gumbel_muzero", gumbel_table=table)

    train, problems, policy, state, buffer = short_train(
        with_sims(gumbel_config, SHORT_TRAIN_SIMS), card, "gumbel_muzero", 0)
    # reanalyze searches with the pUCT search, through the kernel
    sims = SHORT_TRAIN_SIMS
    buffer.reanalyze_ratio = 0.25
    before = _build.launches[DESCENT]
    buffer.sample(int(policy.cfg.batch_size), state.target_model)
    torch.cuda.synchronize()
    train["reanalyze_launches"] = _build.launches[DESCENT] - before
    buffer.reanalyze_ratio = 0.0
    emit(train)
    if train["reanalyze_launches"] != sims:
        problems.append(f"a reanalyze sample launched {train['reanalyze_launches']}, expected {sims}")
    if problems:
        raise AssertionError(f"gumbel_muzero train failed: {problems}")
    return dict(eval=ev, eval_descent_timed=timed, card_vs_cpu=agreement, train=train)


def timed_descents(module, name: str):
    """Replace ``module.name`` (a descent) by a wrapper that times each call
    on the host between two device syncs (the descent reads back a flag per
    level) and counts calls and levels; returns (counters, restore)."""
    descent = dict(calls=0, s=0.0, levels=0)
    traverse = getattr(module, name)

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = traverse(*args)
        torch.cuda.synchronize()
        descent["s"] += time.perf_counter() - t0
        descent["calls"] += 1
        descent["levels"] += int(st.depth.max()) + 1
        return st

    setattr(module, name, timed)
    return descent, lambda: setattr(module, name, traverse)


def descent_record(rec: dict, descent: dict) -> dict:
    rec.update(descent_calls=descent["calls"], descent_s=descent["s"],
               descent_ms_per_call=descent["s"] * 1e3 / max(descent["calls"], 1),
               descent_levels_per_call=descent["levels"] / max(descent["calls"], 1),
               descent_share_of_wall=descent["s"] / rec["wall_s"])
    return rec


def seeded_search_card_vs_cpu(policy, label: str, obs, legal, close=(), **draws) -> dict:
    """``obs`` searched on the card and on the CPU from the same weights,
    with the same ``draws`` (tensors passed to ``_forward_collect``) and
    tie_break='first': root visit counts equal, root values and the outputs
    named in ``close`` within VALUE_TOL (actions are drawn from each
    device's generator and are not compared)."""
    B = obs.shape[0]
    to_play = torch.full((B,), -1, dtype=torch.int32)
    cpu_policy = type(policy)(policy.cfg, model=copy.deepcopy(policy.model).cpu(), device="cpu")
    cpu_policy._collect_task_id = policy._collect_task_id  # a multitask view's task
    search_cfg = policy.search_cfg
    outs = []
    try:
        for p in (policy, cpu_policy):
            p.search_cfg = dataclasses.replace(search_cfg, tie_break="first")
            d = p.device
            outs.append(p._forward_collect(obs.to(d), legal.to(d), to_play.to(d), 1.0, 0.0,
                                           **{k: v.to(d) for k, v in draws.items()}))
    finally:
        policy.search_cfg = search_cfg
    on_card, on_cpu = ({k: v.cpu() for k, v in o.items()} for o in outs)
    if not torch.equal(on_card["visit_counts"], on_cpu["visit_counts"]):
        raise AssertionError(f"{label}: card and CPU visit counts differ: "
                             f"{on_card['visit_counts'].tolist()} vs {on_cpu['visit_counts'].tolist()}")
    err = {}
    for key in ("searched_value", "predicted_value") + tuple(close):
        a, b = on_card[key].float(), on_cpu[key].float()
        err[key] = float((a - b).abs().max())
        if not (torch.isfinite(a).all() and torch.allclose(a, b, rtol=VALUE_TOL, atol=VALUE_TOL)):
            raise AssertionError(f"{label}: card and CPU {key} differ: {a.tolist()} vs {b.tolist()}")
    rec = dict(phase=f"{label}_card_vs_cpu", batch=B, tie_break="first",
               visit_counts=on_card["visit_counts"].tolist(),
               searched_value=on_card["searched_value"].tolist(), max_abs_err=err)
    emit(rec)
    return rec


def stochastic_search_card_vs_cpu(policy) -> dict:
    """4 numpy-seeded 2048 boards, with the same Dirichlet noise and the same
    chance draws on the card and on the CPU."""
    rng = np.random.default_rng(MAIN_SEED + 5)
    B, W, A = 4, policy.tree_width, policy.action_space
    sims = policy.search_cfg.num_simulations
    boards = rng.integers(0, 8, (B, 4, 4))
    boards[rng.random((B, 4, 4)) < 0.4] = 0
    boards = torch.from_numpy(boards.astype(np.int32))
    obs = torch.nn.functional.one_hot(boards.long(), 16).to(torch.float32)
    legal = legal_moves(boards)
    wide_legal = torch.cat([legal, torch.zeros((B, W - A), dtype=torch.bool)], dim=1)
    noise = np.zeros((B, W), np.float32)
    noise[:, :A] = rng.dirichlet(np.full(A, 0.3), B)
    noise = torch.where(wide_legal, torch.from_numpy(noise), 0.0)
    noise = noise / noise.sum(dim=1, keepdim=True)
    chance = torch.from_numpy(rng.gumbel(size=(sims, sims + 2, B, W)).astype(np.float32))
    return seeded_search_card_vs_cpu(policy, "stochastic_muzero", obs, legal, noise=noise,
                                     chance_noise=chance)


def sampled_search_card_vs_cpu(policy, label: str) -> dict:
    """4 numpy-seeded Pendulum states, with the same root and per-simulation
    candidate draws and the same Dirichlet noise on the card and on the CPU;
    the root candidates within VALUE_TOL too."""
    rng = np.random.default_rng(MAIN_SEED + 6)
    B, K, sims = 4, policy.K, policy.search_cfg.num_simulations
    theta, theta_dot = rng.uniform(-np.pi, np.pi, B), rng.uniform(-1, 1, B)
    obs = torch.from_numpy(np.stack([np.cos(theta), np.sin(theta), theta_dot], 1).astype(np.float32))

    def normals(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return seeded_search_card_vs_cpu(
        policy, label, obs, torch.ones((B, 1), dtype=torch.bool), close=("root_sampled_actions",),
        noise=torch.from_numpy(rng.dirichlet(np.full(K, 0.3), B).astype(np.float32)),
        root_draws=normals(B, K, 1), sim_draws=normals(sims, B, K, 1))


def phase_stochastic(card: str) -> dict:
    """Stochastic MuZero on 2048 at full width: its search takes the generic
    descent in plain PyTorch, so no phase launches the descent kernel."""
    policy = StochasticMuZeroPolicy(stoch_config.policy, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 5)
    sims = policy.search_cfg.num_simulations
    ev = eval_episodes(policy, card, "stochastic_muzero",
                       env=Game2048Env(max_episode_steps=STOCH_EVAL_STEPS))
    ev.update(config="game_2048_stochastic_muzero", num_simulations=sims,
              episodes_truncated_at=STOCH_EVAL_STEPS)
    emit(ev)
    if ev["launches"] != 0:
        raise AssertionError(f"stochastic_muzero: the eval launched the pUCT kernel "
                             f"{ev['launches']} times")
    # its backups mark chance nodes through the backup kernel
    check_backup_launches(ev, sims, "stochastic_muzero")

    descent, restore = timed_descents(puct, "_generic_traverse")
    try:
        timed = eval_episodes(policy, card, "stochastic_muzero_descent_timed",
                              env=Game2048Env(max_episode_steps=STOCH_TIMED_EVAL_STEPS))
    finally:
        restore()
    timed = descent_record(dict(timed, episodes_truncated_at=STOCH_TIMED_EVAL_STEPS), descent)
    emit(timed)
    if descent["calls"] != timed["env_steps"] * sims:
        raise AssertionError(f"stochastic_muzero: {descent['calls']} descents for "
                             f"{timed['env_steps']} searches x {sims}")
    agreement = stochastic_search_card_vs_cpu(policy)

    cfg = copy.deepcopy(stoch_config)
    cfg.env.max_episode_steps = STOCH_TRAIN_EPISODE_STEPS
    cfg.policy.num_simulations = STOCH_TRAIN_SIMS
    train, problems, *_ = short_train(cfg, card, "stochastic_muzero", 0)
    train.update(episodes_truncated_at=STOCH_TRAIN_EPISODE_STEPS)
    emit(train)
    if problems:
        raise AssertionError(f"stochastic_muzero train failed: {problems}")
    return dict(eval=ev, eval_descent_timed=timed, card_vs_cpu=agreement, train=train)


def phase_sampled(card: str, l2_ns: float) -> tuple:
    """Sampled MuZero and Sampled EfficientZero on Pendulum at full width:
    their searches are the pUCT search with the K=20 candidates as the
    tree's action slots, through the descent kernel's row-read route."""
    records, cases = {}, []
    for i, (label, policy_cls, config) in enumerate((
            ("sampled_muzero", SampledMuZeroPolicy, smz_config),
            ("sampled_efficientzero", SampledEfficientZeroPolicy, sez_config))):
        policy = policy_cls(config.policy, device="cuda", seed=MAIN_SEED)
        randomize_heads(policy.model, MAIN_SEED + 6 + i)
        sims = policy.search_cfg.num_simulations
        # Pendulum's rewards are costs: a return lies in [-16.3 steps, 0]
        ev = eval_episodes(policy, card, label, env=PendulumEnv(max_episode_steps=SAMPLED_EVAL_STEPS),
                           returns_range=(-17.0 * SAMPLED_EVAL_STEPS, 0.0))
        ev.update(config=f"pendulum_{label}", num_simulations=sims, K=policy.K,
                  route=kernel_route(policy.K), episodes_truncated_at=SAMPLED_EVAL_STEPS)
        emit(ev)
        if ev["launches"] != ev["env_steps"] * sims:
            raise AssertionError(f"{label}: traverse launches {ev['launches']} != env steps "
                                 f"{ev['env_steps']} x {sims}")
        agreement = sampled_search_card_vs_cpu(policy, label)
        if policy_cls is SampledMuZeroPolicy:
            obs = PendulumEnv().reset(3, torch.Generator().manual_seed(MAIN_SEED))[1]
            legal = torch.ones((3, 1), dtype=torch.bool)
            captures = capture_descent_inputs(policy, obs.cuda(), legal.cuda(),
                                              SAMPLED_CAPTURED_SIMS)
            if sorted(captures) != list(SAMPLED_CAPTURED_SIMS):
                raise AssertionError(f"captured simulations {sorted(captures)}, "
                                     f"expected {SAMPLED_CAPTURED_SIMS}")
            cases += phase_captured(captures, l2_ns, search=f"{label} eval search")

        cfg = copy.deepcopy(config)
        cfg.env.max_episode_steps = SAMPLED_TRAIN_EPISODE_STEPS
        cfg.env.stop_value = 1.0  # out of reach: a return is at most 0
        train, problems, *_ = short_train(cfg, card, label, sims, halved_round=False)
        train.update(episodes_truncated_at=SAMPLED_TRAIN_EPISODE_STEPS, stop_value=1.0)
        emit(train)
        if problems:
            raise AssertionError(f"{label} train failed: {problems}")
        records[label] = dict(eval=ev, card_vs_cpu=agreement, train=train)
    return records, cases


def newest_covering(buffer, partition: float) -> list:
    """The episodes, newest first, that reanalyze_buffer picks: the newest
    ones until they hold ``partition`` of the stored transitions."""
    budget, covered, episodes = int(buffer.num_transitions * partition), 0, []
    for e in range(buffer.num_episodes - 1, -1, -1):
        episodes.append(e)
        covered += len(buffer._episodes[e].actions)
        if covered >= budget:
            break
    return episodes


def watch_reanalyze(sims: int):
    """Wrap GameBuffer.reanalyze_buffer and the generic descent: each call
    records what it should launch and descend, worked out from the buffer
    it is given (only a reuse group's first search, or each plain batch,
    takes the kernel; every later search of a group descends
    longest episode - 1 times per simulation), and what it launched,
    descended and returned. Returns (calls, restore)."""
    calls, descents = [], [0]
    reanalyze, generic = GameBuffer.reanalyze_buffer, puct._generic_traverse

    def counting_generic(*args, **kwargs):
        descents[0] += 1
        return generic(*args, **kwargs)

    def watched(self, target_model, reanalyze_batch_size=256, partition=0.75,
                reuse_search=False):
        lengths = [len(self._episodes[e].actions) for e in newest_covering(self, partition)]
        G = reanalyze_batch_size
        if reuse_search:
            groups = [lengths[i:i + G] for i in range(0, len(lengths), G)]
            expected_launches = sims * len(groups)
            expected_descents = sims * sum(max(g) - 1 for g in groups)
        else:
            expected_launches, expected_descents = sims * math.ceil(sum(lengths) / G), 0
        launches, descended = _build.launches[DESCENT], descents[0]
        t0 = time.perf_counter()
        n = reanalyze(self, target_model, reanalyze_batch_size, partition, reuse_search)
        torch.cuda.synchronize()
        calls.append(dict(
            reuse_search=reuse_search, batch=G, episodes=len(lengths),
            longest_episode=max(lengths), transitions=n, expected_transitions=sum(lengths),
            launches=_build.launches[DESCENT] - launches, expected_launches=expected_launches,
            generic_descents=descents[0] - descended, expected_generic_descents=expected_descents,
            wall_s=time.perf_counter() - t0))
        return n

    GameBuffer.reanalyze_buffer = watched
    puct._generic_traverse = counting_generic

    def restore():
        GameBuffer.reanalyze_buffer = reanalyze
        puct._generic_traverse = generic

    return calls, restore


def reanalyze_problems(calls: list) -> list:
    return [f"reanalyze {c}" for c in calls
            if (c["launches"], c["generic_descents"], c["transitions"])
            != (c["expected_launches"], c["expected_generic_descents"], c["expected_transitions"])]


def reuse_search_card_vs_cpu(policy) -> dict:
    """A reuse search (forward_reanalyze with true actions and reused values)
    of 4 numpy-seeded CartPole states on the card and on the CPU, with the
    same Dirichlet noise and tie_break='first': the visit distributions
    equal, the root values within VALUE_TOL, and no kernel launch."""
    rng = np.random.default_rng(MAIN_SEED + 8)
    B = 4
    obs = torch.from_numpy(rng.uniform(-0.2, 0.2, (B, 4)).astype(np.float32))
    legal = torch.ones((B, 2), dtype=torch.bool)
    noise = torch.from_numpy(rng.dirichlet(np.full(2, 0.3), B).astype(np.float32))
    true_action = torch.from_numpy(rng.integers(0, 2, B))
    reuse_value = torch.from_numpy(rng.uniform(0.0, 20.0, B).astype(np.float32))
    cpu_policy = type(policy)(policy.cfg, model=copy.deepcopy(policy.model).cpu(), device="cpu")
    search_cfg = policy.search_cfg
    outs = []
    launches = _build.launches[DESCENT]
    try:
        for p in (policy, cpu_policy):
            p.search_cfg = dataclasses.replace(search_cfg, tie_break="first")
            d = p.device
            visits, values = p.forward_reanalyze(
                p.model, obs.to(d), legal.to(d), true_action=true_action.to(d),
                reuse_value=reuse_value.to(d), noise=noise.to(d))
            outs.append((visits.cpu(), values.cpu()))
    finally:
        policy.search_cfg = search_cfg
    launches = _build.launches[DESCENT] - launches
    (card_visits, card_values), (cpu_visits, cpu_values) = outs
    err = float((card_values - cpu_values).abs().max())
    rec = dict(phase="rezero_reuse_card_vs_cpu", batch=B, tie_break="first",
               true_action=true_action.tolist(), reuse_value=reuse_value.tolist(),
               visit_distribution=card_visits.tolist(), root_value=card_values.tolist(),
               max_abs_err=err, launches=launches)
    emit(rec)
    if not torch.equal(card_visits, cpu_visits):
        raise AssertionError(f"rezero: card and CPU reuse searches differ: "
                             f"{card_visits.tolist()} vs {cpu_visits.tolist()}")
    if not (torch.isfinite(card_values).all()
            and torch.allclose(card_values, cpu_values, rtol=VALUE_TOL, atol=VALUE_TOL)):
        raise AssertionError(f"rezero: card and CPU root values differ: "
                             f"{card_values.tolist()} vs {cpu_values.tolist()}")
    if launches:
        raise AssertionError(f"rezero: the reuse search launched the descent kernel {launches} times")
    return rec


def context_card_vs_cpu(policy) -> dict:
    """CONTEXT_STEPS stateful eval steps of 3 envs on the card and on the
    CPU from the same weights and numpy-seeded observations, env 1's episode
    ending after step 2: the root latents within LATENT_TOL, the contexts,
    visit counts and actions equal; env 0 is encoded again at step 5 (the
    context reset) and env 1 at step 3."""
    rng = np.random.default_rng(MAIN_SEED + 9)
    B = 3
    steps = [torch.from_numpy(rng.uniform(-0.2, 0.2, (B, 4)).astype(np.float32))
             for _ in range(CONTEXT_STEPS)]
    done = torch.tensor([False, True, False])
    legal = torch.ones((B, 2), dtype=torch.bool)
    to_play = torch.full((B,), -1, dtype=torch.int32)
    cpu_policy = type(policy)(policy.cfg, model=copy.deepcopy(policy.model).cpu(), device="cpu")
    runs = []
    for p in (policy, cpu_policy):
        d, state, run = p.device, p.init_collect_state(B), []
        for t, obs in enumerate(steps):
            out, state = p._forward_collect_stateful(obs.to(d), legal.to(d), to_play.to(d), 1.0,
                                                     0.0, state, deterministic=True)
            with torch.no_grad():
                encoded = p.model.representation(obs.to(d))
            run.append(dict(latent=state["latent"].cpu(), encoded=encoded.cpu(),
                            action=out["action"].cpu(), visit_counts=out["visit_counts"].cpu(),
                            timestep=state["timestep"].cpu()))
            if t == 2:
                state = p.reset_collect_state(state, done.to(d))
        runs.append(run)
    err = max(float((a["latent"] - b["latent"]).abs().max()) for a, b in zip(*runs))
    reencoded = [torch.isclose(r["latent"], r["encoded"], rtol=0, atol=1e-6).all(-1).tolist()
                 for r in runs[0]]
    rec = dict(phase="muzero_context_card_vs_cpu", batch=B, steps=CONTEXT_STEPS,
               latent_max_abs_err=err, encoded_at=reencoded,
               actions=[r["action"].tolist() for r in runs[0]])
    emit(rec)
    for t, (a, b) in enumerate(zip(*runs)):
        for key in ("action", "visit_counts", "timestep"):
            if not torch.equal(a[key], b[key]):
                raise AssertionError(f"muzero_context: card and CPU {key} differ at step {t}")
    if err > LATENT_TOL:
        raise AssertionError(f"muzero_context: root latents differ by {err} > {LATENT_TOL}")
    if [r[0] for r in reencoded] != [True, False, False, False, False, True, False] or \
            [r[1] for r in reencoded] != [True, False, False, True, False, False, False]:
        raise AssertionError(f"muzero_context: encoded at the wrong steps: {reencoded}")
    return rec


def phase_rezero_history(card: str) -> dict:
    """ReZero, MuZero-Context and MuZero-RNN-full-obs on CartPole at full
    width; every collect and eval search through the descent kernel, the
    reuse searches through the generic descent."""
    records, t0 = {}, time.perf_counter()
    # ReZero: MuZero with the whole-buffer reuse reanalyze
    policy = MuZeroPolicy(rezero_config.policy, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 8)
    sims = policy.search_cfg.num_simulations
    ev = eval_episodes(policy, card, "rezero")
    emit(ev)
    if ev["launches"] != ev["env_steps"] * sims:
        raise AssertionError(f"rezero: traverse launches {ev['launches']} != env steps "
                             f"{ev['env_steps']} x {sims}")
    cfg = copy.deepcopy(rezero_config)
    cfg.env.max_episode_steps = REZERO_TRAIN_EPISODE_STEPS
    cfg.policy.num_simulations = SHORT_TRAIN_SIMS
    calls, restore = watch_reanalyze(SHORT_TRAIN_SIMS)
    try:
        train, problems, policy, state, buffer = short_train(
            cfg, card, "rezero", SHORT_TRAIN_SIMS,
            extra_launches=lambda: sum(c["expected_launches"] for c in calls))
        reuse = reuse_search_card_vs_cpu(policy)
        buffer.reanalyze_buffer(state.target_model, reanalyze_batch_size=160, partition=0.75,
                                reuse_search=False)
    finally:
        restore()
    train.update(episodes_truncated_at=REZERO_TRAIN_EPISODE_STEPS, reanalyze=calls[:-1],
                 plain_reanalyze=calls[-1])
    emit(train)
    problems += reanalyze_problems(calls)
    if [c["transitions"] for c in calls[:-1]] != train["logged_reanalyzed"] or len(calls) != 2:
        problems.append(f"logged reanalyze counts {train['logged_reanalyzed']}, calls {calls}")
    if problems:
        raise AssertionError(f"rezero failed: {problems}")
    records["rezero"] = dict(eval=ev, train=train, reuse_card_vs_cpu=reuse)

    # MuZero-Context: the stateful collect and eval path
    policy = MuZeroContextPolicy(context_config.policy, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 9)
    ev = eval_episodes(policy, card, "muzero_context")
    emit(ev)
    if ev["launches"] != ev["env_steps"] * sims:
        raise AssertionError(f"muzero_context: traverse launches {ev['launches']} != env steps "
                             f"{ev['env_steps']} x {sims}")
    latents = context_card_vs_cpu(policy)
    train, problems, *_ = short_train(with_sims(context_config, SHORT_TRAIN_SIMS), card,
                                      "muzero_context", SHORT_TRAIN_SIMS)
    emit(train)
    if problems:
        raise AssertionError(f"muzero_context train failed: {problems}")
    records["muzero_context"] = dict(eval=ev, train=train, card_vs_cpu=latents)

    # MuZero-RNN-full-obs at the CartPole MuZero config's width
    cfg = copy.deepcopy(main_config)
    cfg.policy.type = "muzero_rnn_full_obs"
    cfg.policy.model.rnn_hidden_size = RNN_HIDDEN_SIZE
    policy = MuZeroRNNFullObsPolicy(cfg.policy, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 10)
    ev = eval_episodes(policy, card, "muzero_rnn")
    emit(ev)
    if ev["launches"] != ev["env_steps"] * sims:
        raise AssertionError(f"muzero_rnn: traverse launches {ev['launches']} != env steps "
                             f"{ev['env_steps']} x {sims}")
    agreement = search_card_vs_cpu(policy, "muzero_rnn")
    train, problems, *_ = short_train(with_sims(cfg, SHORT_TRAIN_SIMS), card, "muzero_rnn",
                                      SHORT_TRAIN_SIMS)
    emit(train)
    if problems:
        raise AssertionError(f"muzero_rnn train failed: {problems}")
    records["muzero_rnn"] = dict(eval=ev, train=train, card_vs_cpu=agreement)
    return records, time.perf_counter() - t0


def grid_states(env, n: int, seed: int) -> tuple:
    """``n`` grid observations and legal masks from seeded random play (each
    env a few steps into its episode)."""
    g = torch.Generator().manual_seed(seed)
    state, obs = env.reset(n, g)
    for _ in range(3):
        step = env.step(state, torch.randint(0, env.action_space_size, (n,), generator=g), g)
        state, obs = step.state, step.obs
    return obs, env.legal_mask(state)


def atari_width_card_vs_cpu(card: str) -> dict:
    """Conv MuZero at the Atari config's width (zoo/atari/config/
    atari_muzero_config.py: 96x96x12, 64 channels, downsample, A=6, supports
    of 601 atoms): one initial and one recurrent inference of ATARI_BATCH
    seeded frames on the card and on the CPU, every output within
    ATARI_TOL; the card's times from CUDA events."""
    cfg = MuZeroPolicy.default_config().model
    cfg.update(observation_shape=(96, 96, 12), action_space_size=6, model_type="conv",
               num_channels=64, downsample=True, value_support_size=601,
               reward_support_size=601, self_supervised_learning_loss=True)
    model = MuZeroModel.from_config(cfg, torch.Generator().manual_seed(MAIN_SEED + 13))
    randomize_heads(model, MAIN_SEED + 13)
    rng = np.random.default_rng(MAIN_SEED + 13)
    obs = torch.from_numpy(rng.random((ATARI_BATCH, 96, 96, 12)).astype(np.float32))
    action = torch.from_numpy(rng.integers(0, 6, ATARI_BATCH))
    outs = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev).eval()
        with torch.no_grad():
            out0 = m.initial_inference(obs.to(dev))
            out1 = m.recurrent_inference(out0.latent_state, action.to(dev))
        outs[dev] = [t.cpu() for t in (*out0, *out1)]
    m = model.cuda().eval()
    with torch.no_grad():
        initial_ms = cuda_ms(lambda: m.initial_inference(obs.cuda()), reps=10)
        latent = m.initial_inference(obs.cuda()).latent_state
        recurrent_ms = cuda_ms(lambda: m.recurrent_inference(latent, action.cuda()), reps=10)
    names = ["value_logits", "reward_logits", "policy_logits", "latent_state"]
    err = {}
    for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
        step = "initial" if i < 4 else "recurrent"
        key = f"{step}_{names[i % 4]}"
        err[key] = float((a - b).abs().max())
        if not (torch.isfinite(a).all() and torch.allclose(a, b, rtol=ATARI_TOL, atol=ATARI_TOL)):
            raise AssertionError(f"atari width: card and CPU {key} differ by {err[key]}")
    rec = dict(phase="atari_width_card_vs_cpu", batch=ATARI_BATCH, observation=[96, 96, 12],
               num_channels=64, latent=list(outs["cuda"][3].shape[1:]), max_abs_err=err,
               initial_inference_ms=initial_ms, recurrent_inference_ms=recurrent_ms, card=card)
    emit(rec)
    return rec


def phase_grid(card: str, l2_ns: float) -> tuple:
    """Conv MuZero on Grid Breakout and conv EfficientZero on the Space
    Invaders grid at the zoo configs' width, their searches through the
    descent kernel's small-A route; then the Atari-width conv model."""
    records, cases, t0 = {}, [], time.perf_counter()
    for i, (label, policy_cls, config, env_cls) in enumerate((
            ("breakout_muzero", MuZeroPolicy, breakout_config, BreakoutGridEnv),
            ("space_invaders_efficientzero", EfficientZeroPolicy, invaders_config,
             SpaceInvadersGridEnv))):
        policy = policy_cls(config.policy, device="cuda", seed=MAIN_SEED)
        randomize_heads(policy.model, MAIN_SEED + 11 + i)
        sims = policy.search_cfg.num_simulations
        A = env_cls.action_space_size
        ev = eval_episodes(policy, card, label, env=env_cls(max_steps=GRID_EVAL_STEPS),
                           returns_range=(0.0, float(GRID_EVAL_STEPS)))
        ev.update(config=label, num_simulations=sims, A=A, route=kernel_route(A),
                  episodes_truncated_at=GRID_EVAL_STEPS)
        emit(ev)
        if ev["launches"] != ev["env_steps"] * sims:
            raise AssertionError(f"{label}: traverse launches {ev['launches']} != env steps "
                                 f"{ev['env_steps']} x {sims}")
        obs, legal = grid_states(env_cls(), 4, MAIN_SEED + 11 + i)
        noise = np.random.default_rng(MAIN_SEED + 11 + i).dirichlet(np.full(A, 0.3), 4)
        agreement = seeded_search_card_vs_cpu(policy, label, obs, legal,
                                              noise=torch.from_numpy(noise.astype(np.float32)))
        obs, legal = grid_states(env_cls(), 3, MAIN_SEED + 21 + i)
        captures = capture_descent_inputs(policy, obs.cuda(), legal.cuda(), GRID_CAPTURED_SIMS)
        if sorted(captures) != list(GRID_CAPTURED_SIMS):
            raise AssertionError(f"captured simulations {sorted(captures)}, "
                                 f"expected {GRID_CAPTURED_SIMS}")
        cases += phase_captured(captures, l2_ns, search=f"{label} eval search")

        cfg = copy.deepcopy(config)
        cfg.env.max_steps = GRID_TRAIN_EPISODE_STEPS
        cfg.policy.num_simulations = SHORT_TRAIN_SIMS
        train, problems, *_ = short_train(cfg, card, label, SHORT_TRAIN_SIMS)
        train.update(episodes_truncated_at=GRID_TRAIN_EPISODE_STEPS)
        emit(train)
        if problems:
            raise AssertionError(f"{label} train failed: {problems}")
        records[label] = dict(eval=ev, card_vs_cpu=agreement, train=train)
    records["atari_width"] = atari_width_card_vs_cpu(card)
    return records, cases, time.perf_counter() - t0


def probe_states(env, n: int, seed: int, steps: int = 3) -> tuple:
    """``n`` states, observations and legal masks of the env from seeded
    random legal play, ``steps`` steps into each episode."""
    g = torch.Generator().manual_seed(seed)
    state, obs = env.reset(n, g)
    for _ in range(steps):
        legal = env.legal_mask(state)
        step = env.step(state, torch.multinomial(legal.to(torch.float32), 1, generator=g)[:, 0], g)
        state, obs = step.state, step.obs
    return state, obs, env.legal_mask(state)


def dirichlet_on(legal: torch.Tensor, seed: int) -> torch.Tensor:
    """(B, A) Dirichlet(0.3) noise over each row's legal actions."""
    rng = np.random.default_rng(seed)
    noise = np.zeros(legal.shape, np.float32)
    for i, row in enumerate(legal.numpy()):
        noise[i, row] = rng.dirichlet(np.full(int(row.sum()), 0.3))
    return torch.from_numpy(noise)


def phase_probes(card: str, l2_ns: float) -> tuple:
    """Catch MuZero and Memory EfficientZero at the zoo configs' width: MLP
    searches through the descent kernel's small-A route."""
    records, cases, t0 = {}, [], time.perf_counter()
    for i, (label, policy_cls, config, env) in enumerate((
            ("catch_muzero", MuZeroPolicy, catch_config, CatchEnv(rows=10, cols=5)),
            ("memory_efficientzero", EfficientZeroPolicy, memory_config,
             MemoryEnv(num_cues=4, memory_length=10)))):
        policy = policy_cls(config.policy, device="cuda", seed=MAIN_SEED)
        randomize_heads(policy.model, MAIN_SEED + 31 + i)
        sims = policy.search_cfg.num_simulations
        A = env.action_space_size
        ev = eval_episodes(policy, card, label, env=env, returns_range=(-1.0, 1.0))
        ev.update(config=label, num_simulations=sims, A=A, route=kernel_route(A))
        emit(ev)
        if ev["launches"] != ev["env_steps"] * sims:
            raise AssertionError(f"{label}: traverse launches {ev['launches']} != env steps "
                                 f"{ev['env_steps']} x {sims}")
        if label == "catch_muzero":
            _, obs, legal = probe_states(env, 3, MAIN_SEED + 31)
            captures = capture_descent_inputs(policy, obs.cuda(), legal.cuda(), PROBE_CAPTURED_SIMS)
            if sorted(captures) != list(PROBE_CAPTURED_SIMS):
                raise AssertionError(f"captured simulations {sorted(captures)}, "
                                     f"expected {PROBE_CAPTURED_SIMS}")
            cases += phase_captured(captures, l2_ns, search=f"{label} eval search")
        cfg = with_sims(config, SHORT_TRAIN_SIMS)
        # out of reach (a return is at most 1): at 10 simulations Catch's
        # iter-0 eval caught every ball and the run stopped before collecting
        cfg.env.stop_value = 2.0
        train, problems, *_ = short_train(cfg, card, label, SHORT_TRAIN_SIMS)
        emit(train)
        if problems:
            raise AssertionError(f"{label} train failed: {problems}")
        records[label] = dict(eval=ev, train=train)
    return records, cases, time.perf_counter() - t0


def az_positions(env, seed: int) -> tuple:
    """4 self-play positions of ``env``: two 2 plies in (player 1 to move)
    and two 3 plies in (player 2): (state, legal)."""
    (a, _, legal_a), (b, _, legal_b) = (probe_states(env, 2, seed + plies, plies)
                                        for plies in (2, 3))
    return type(a)(*(torch.cat([x, y]) for x, y in zip(a, b))), torch.cat([legal_a, legal_b])


def az_search_card_vs_cpu(policy, label: str, state, close=(), tol=VALUE_TOL, **draws) -> dict:
    """Positions searched on the card and on the CPU from the same weights,
    with the same ``draws`` (passed to ``_forward_collect``) and
    tie_break='first': visit counts equal (the raw ones, where the stored
    target is Gumbel AlphaZero's improved policy), root values within
    VALUE_TOL and the outputs named in ``close`` within ``tol``."""
    cpu_policy = type(policy)(policy.cfg, policy.env, model=copy.deepcopy(policy.model).cpu(),
                              device="cpu")
    search_cfg = policy.search_cfg
    outs = []
    try:
        for p in (policy, cpu_policy):
            p.search_cfg = dataclasses.replace(search_cfg, tie_break="first")
            on = type(state)(*(x.to(p.device) for x in state))
            outs.append(p._forward_collect(on, 1.0, **{k: v.to(p.device) for k, v in draws.items()}))
    finally:
        policy.search_cfg = search_cfg
    on_card, on_cpu = ({k: v.cpu() for k, v in o.items()} for o in outs)
    visits = "raw_visit_counts" if "raw_visit_counts" in on_card else "visit_counts"
    if not torch.equal(on_card[visits], on_cpu[visits]):
        raise AssertionError(f"{label}: card and CPU visit counts differ: "
                             f"{on_card[visits].tolist()} vs {on_cpu[visits].tolist()}")
    err = {}
    for key, t in [(k, VALUE_TOL) for k in ("searched_value", "predicted_value")] + [
            (k, tol) for k in close]:
        a, b = on_card[key].float(), on_cpu[key].float()
        err[key] = float((a - b).abs().max())
        if not (torch.isfinite(a).all() and torch.allclose(a, b, rtol=t, atol=t)):
            raise AssertionError(f"{label}: card and CPU {key} differ: {a.tolist()} vs {b.tolist()}")
    rec = dict(phase=f"{label}_card_vs_cpu", batch=int(state.to_play.shape[0]), tie_break="first",
               to_play=state.to_play.tolist(), visit_counts=on_card[visits].tolist(),
               searched_value=on_card["searched_value"].tolist(), max_abs_err=err)
    emit(rec)
    return rec


def az_learn_step_card_vs_cpu(policy, batch, label: str) -> tuple:
    """One AlphaZero learn step (clip, then AdamW) on the card and one on the
    CPU from the same params and batch, each with a fresh optimizer, held as
    learn_step_card_vs_cpu holds MuZero's (AdamW's decay stays outside the
    gradient Adam sees): (record, agree)."""
    results = {}
    for dev in ("cuda", "cpu"):
        p = type(policy)(policy.cfg, policy.env, model=copy.deepcopy(policy.model), device=dev)
        state = p.init_train_state()
        _, logs = p.forward_learn(state, batch_to(batch, p.device))
        results[dev] = dict(logs={k: float(v) for k, v in logs.items()},
                            params={k: v.detach().cpu() for k, v in p.model.named_parameters()},
                            g={k: v.grad.cpu() for k, v in p.model.named_parameters()})
    card, cpu = results["cuda"], results["cpu"]
    lr = float(policy.cfg.learning_rate)
    log_err, tight_err, loose_err, loose, total = compare_learn_steps(card, cpu)
    rec = dict(phase=f"{label}_train_card_vs_cpu", batch=int(batch.obs.shape[0]),
               max_log_rel_err=max(log_err.values()), log_rel_err=log_err,
               param_max_abs_err=tight_err, param_max_abs_err_rounding_bound=loose_err,
               rounding_bound_elements=loose, elements=total,
               total_loss_card=card["logs"]["total_loss"], total_loss_cpu=cpu["logs"]["total_loss"])
    emit(rec)
    agree = (rec["max_log_rel_err"] <= LEARN_LOG_RTOL and tight_err <= LEARN_PARAM_ATOL
             and loose_err <= 2 * lr and loose < total // 4)
    return rec, agree


def az_batch(replay, batch_size: int, seed: int) -> AZTrainBatch:
    """A batch drawn with replacement from AlphaZero's replay, on the card."""
    idx = np.random.default_rng(seed).integers(0, len(replay), batch_size)
    return AZTrainBatch(
        obs=torch.from_numpy(np.stack([replay[i].obs for i in idx])).cuda(),
        target_policy=torch.from_numpy(np.stack([replay[i].probs for i in idx])).cuda(),
        target_value=torch.from_numpy(np.asarray([replay[i].z for i in idx], np.float32)).cuda())


def phase_alphazero(card: str) -> tuple:
    """TicTacToe AlphaZero at the zoo config's width: the env is the search's
    simulator and the players alternate, so every search takes the generic
    descent and none launches the kernel."""
    t0 = time.perf_counter()
    _build.launches[DESCENT] = 0
    policy = AlphaZeroPolicy(ttt_az_config.policy, TicTacToeEnv("self_play_mode"), device="cuda",
                             seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 41)
    sims = policy.search_cfg.num_simulations
    state, legal = az_positions(policy.env, MAIN_SEED + 41)
    agreement = az_search_card_vs_cpu(policy, "tictactoe_alphazero", state,
                                      noise=dirichlet_on(legal, MAIN_SEED + 41))

    collector = AlphaZeroSelfPlayCollector(policy.env, policy, 8, seed=MAIN_SEED)
    samples, cstats = collector.collect(temperature=1.0, num_episodes=8)
    torch.cuda.synchronize()
    collect = dict(phase="tictactoe_alphazero_collect", num_envs=8, samples=len(samples),
                   env_steps=cstats["steps"], episodes=cstats["episodes"],
                   wall_s=cstats["duration"], steps_per_s=cstats["steps_per_sec"], card=card)
    emit(collect)
    if cstats["episodes"] < 8 or not samples or any(s.z not in (-1.0, 0.0, 1.0) for s in samples):
        raise AssertionError(f"alphazero collect: {cstats['episodes']} games, {len(samples)} samples")

    descent, restore = timed_descents(puct, "_generic_traverse")
    try:
        evaluator = AlphaZeroBotEvaluator(TicTacToeEnv("play_with_bot_mode"), policy, 5,
                                          seed=MAIN_SEED)
        res = evaluator.eval(AZ_EVAL_EPISODES)
        torch.cuda.synchronize()
    finally:
        restore()
    ev = descent_record(dict(phase="tictactoe_alphazero_eval", num_envs=5,
                             episode_returns=res["episode_returns"], win_rate=res["win_rate"],
                             env_steps=res["env_steps"], wall_s=res["duration"],
                             wall_per_env_step_s=res["duration"] / res["env_steps"], card=card),
                        descent)
    emit(ev)
    if (len(res["episode_returns"]) != AZ_EVAL_EPISODES
            or not set(res["episode_returns"]) <= {-1.0, 0.0, 1.0}
            or descent["calls"] != res["env_steps"] * sims):
        raise AssertionError(f"alphazero eval: {res['episode_returns']}, {descent['calls']} "
                             f"descents for {res['env_steps']} steps x {sims}")

    cfg = copy.deepcopy(ttt_az_config)
    cfg.policy.update_per_collect = SHORT_TRAIN_ITERS
    cfg.policy.num_simulations = AZ_TRAIN_SIMS
    with tempfile.TemporaryDirectory() as tmp:
        cfg.exp_name = os.path.join(tmp, "tictactoe_alphazero")
        t1 = time.perf_counter()
        trained, state, stats = train_alphazero(cfg, seed=MAIN_SEED,
                                                max_train_iter=SHORT_TRAIN_ITERS)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t1
        with open(os.path.join(cfg.exp_name, "log", "train.jsonl")) as f:
            records = [json.loads(line) for line in f]
    losses = [r["learner/total_loss"] for r in records if "learner/total_loss" in r]
    batch_size = int(trained.cfg.batch_size)
    agreement_learn, agree = az_learn_step_card_vs_cpu(
        trained, az_batch(stats["replay"], batch_size, MAIN_SEED), "tictactoe_alphazero")
    step_ms, timed_losses = [], []
    for i in range(TIMED_LEARN_STEPS):
        batch = az_batch(stats["replay"], batch_size, MAIN_SEED + 1 + i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, logs = trained.forward_learn(state, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        timed_losses.append(float(logs["total_loss"]))
    params_finite = all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
    launches = _build.launches[DESCENT]
    train = dict(phase="tictactoe_alphazero_train", train_iter=stats["train_iter"],
                 env_steps=stats["env_steps"], replay=len(stats["replay"]),
                 logged_total_losses=losses, wall_s=train_wall,
                 learn_step_ms_median=float(np.median(step_ms)), learn_step_ms=step_ms,
                 card_vs_cpu=agreement_learn, launches=launches, card=card)
    emit(train)
    problems = [] if agree else [f"card and CPU learn steps disagree: {agreement_learn}"]
    if stats["train_iter"] != SHORT_TRAIN_ITERS:
        problems.append(f"train_iter {stats['train_iter']}, expected {SHORT_TRAIN_ITERS}")
    if (not losses or not all(math.isfinite(x) for x in losses + timed_losses)
            or not params_finite):
        problems.append("non-finite loss or params")
    if launches != 0:
        problems.append(f"AlphaZero's searches launched the descent kernel {launches} times")
    if problems:
        raise AssertionError(f"tictactoe_alphazero failed: {problems}")
    return dict(card_vs_cpu=agreement, collect=collect, eval=ev, train=train,
                launches=launches), time.perf_counter() - t0


def phase_connect4(card: str) -> tuple:
    """Connect4 MuZero, the fine-tune config at full width with seeded
    weights: bot-mode searches (to_play -1 under players 2) take the
    generic descent, as in the JAX package, so none launches the kernel.
    The channel-norm kernel's launches in the eval and in one learn step
    are held to the conv networks' sites x calls."""
    t0 = time.perf_counter()
    policy = MuZeroPolicy(connect4_config.policy, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 51)
    sims = policy.search_cfg.num_simulations
    descent, restore = timed_descents(puct, "_generic_traverse")
    try:
        with counted_norm_launches() as norm_eval:
            ev = eval_episodes(policy, card, "connect4_muzero",
                               env=Connect4Env(battle_mode="play_with_bot_mode"),
                               returns_range=(-1.0, 1.0))
    finally:
        restore()
    ev = descent_record(dict(ev, config="connect4_muzero_ft", num_simulations=sims,
                             norm_launches=norm_eval["launches"],
                             norm_expected=norm_eval["expected"]), descent)
    emit(ev)
    check_norm_launches(norm_eval, "connect4_muzero eval")
    if ev["launches"] != 0 or descent["calls"] != ev["env_steps"] * sims:
        raise AssertionError(f"connect4_muzero eval: {ev['launches']} launches, "
                             f"{descent['calls']} descents for {ev['env_steps']} steps x {sims}")
    _, obs, legal = probe_states(Connect4Env("play_with_bot_mode"), 4, MAIN_SEED + 51)
    agreement = seeded_search_card_vs_cpu(policy, "connect4_muzero", obs, legal,
                                          noise=dirichlet_on(legal, MAIN_SEED + 51))
    cfg = copy.deepcopy(connect4_config)
    cfg.policy.num_simulations = C4_TRAIN_SIMS
    cfg.env.evaluator_env_num = cfg.env.n_evaluator_episode = C4_TRAIN_EVAL_EPISODES
    train, problems, trained, state, buffer = short_train(cfg, card, "connect4_muzero", 0)
    # one more learn step, its channel-norm launches held to the sites'
    batch, _ = buffer.sample(int(trained.cfg.batch_size), state.target_model)
    with counted_norm_launches() as norm_learn:
        trained.forward_learn(state, batch)
    train.update(mirror_augmentation=buffer.mirror_augmentation,
                 norm_launches_learn=norm_learn["launches"],
                 norm_expected_learn=norm_learn["expected"])
    emit(train)
    if not buffer.mirror_augmentation:
        problems.append("the buffer does not mirror")
    if problems:
        raise AssertionError(f"connect4_muzero train failed: {problems}")
    check_norm_launches(norm_learn, "connect4_muzero learn step")
    return dict(eval=ev, card_vs_cpu=agreement, train=train), time.perf_counter() - t0


def gumbel_draws(shape, seed: int) -> torch.Tensor:
    """(..., A) standard Gumbel draws from a numpy seed."""
    u = np.random.default_rng(seed).random(shape)
    return torch.from_numpy(-np.log(-np.log(np.maximum(u, 1e-20)))).to(torch.float32)


def az_board_config(config, max_moves=None):
    """A deep copy of an AlphaZero config, its games cut at ``max_moves``
    plies where given (the env's move cap)."""
    cfg = copy.deepcopy(config)
    if max_moves:
        cfg.env.max_moves = max_moves
    return cfg


def az_board_run(card: str, label: str, config, policy_cls, descent_name: str,
                 draws_for, close=(), tol=VALUE_TOL) -> dict:
    """One AlphaZero-family config on a board at its zoo width: 4 self-play
    positions searched card vs CPU with the draws ``draws_for(legal)``
    (seeded heads); a train_alphazero run (device unset: the card) at
    AZ_TRAIN_SIMS simulations whose eval at iter 0 plays BIG_EVAL_EPISODES
    games against the rule bot on 5 envs with its descents timed, then one
    self-play collect of 8 games (more where the replay holds less than a
    batch) and SHORT_TRAIN_ITERS learn steps; one learn step card vs CPU; the median of
    TIMED_LEARN_STEPS learn steps. No search launches the kernel."""
    _build.launches[DESCENT] = 0
    sp_env = build_env(config.env, "self_play_mode")
    policy = policy_cls(config.policy, sp_env, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 61)
    state, legal = az_positions(sp_env, MAIN_SEED + 61)
    agreement = az_search_card_vs_cpu(policy, label, state, close=close, tol=tol,
                                      **draws_for(legal))

    # the run's own eval, its descents timed
    module = gumbel if descent_name == "_gumbel_traverse" else puct
    evals, plain_eval = [], AlphaZeroBotEvaluator.eval

    def timed_eval(evaluator, n_episodes=None):
        descent, restore = timed_descents(module, descent_name)
        try:
            res = plain_eval(evaluator, n_episodes)
            torch.cuda.synchronize()
        finally:
            restore()
        evals.append((res, descent))
        return res

    cfg = copy.deepcopy(config)
    cfg.policy.update_per_collect = SHORT_TRAIN_ITERS
    cfg.policy.num_simulations = AZ_TRAIN_SIMS
    cfg.env.evaluator_env_num, cfg.env.n_evaluator_episode = 5, BIG_EVAL_EPISODES
    AlphaZeroBotEvaluator.eval = timed_eval
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg.exp_name = os.path.join(tmp, label)
            t1 = time.perf_counter()
            trained, tstate, stats = train_alphazero(cfg, seed=MAIN_SEED,
                                                     max_train_iter=SHORT_TRAIN_ITERS)
            torch.cuda.synchronize()
            train_wall = time.perf_counter() - t1
            with open(os.path.join(cfg.exp_name, "log", "train.jsonl")) as f:
                records = [json.loads(line) for line in f]
    finally:
        AlphaZeroBotEvaluator.eval = plain_eval
    (res, descent), = evals
    ev = descent_record(dict(phase=f"{label}_eval", num_envs=5,
                             episode_returns=res["episode_returns"], win_rate=res["win_rate"],
                             env_steps=res["env_steps"], wall_s=res["duration"],
                             wall_per_env_step_s=res["duration"] / res["env_steps"], card=card),
                        descent)
    emit(ev)
    if (len(res["episode_returns"]) != BIG_EVAL_EPISODES
            or not set(res["episode_returns"]) <= {-1.0, 0.0, 1.0}
            or descent["calls"] != res["env_steps"] * AZ_TRAIN_SIMS):
        raise AssertionError(f"{label} eval: {res['episode_returns']}, {descent['calls']} "
                             f"descents for {res['env_steps']} steps x {AZ_TRAIN_SIMS}")
    losses = [r["learner/total_loss"] for r in records if "learner/total_loss" in r]
    collect_sps = [r["collector/steps_per_sec"] for r in records if "collector/steps_per_sec" in r]
    batch_size = int(trained.cfg.batch_size)
    agreement_learn, agree = az_learn_step_card_vs_cpu(
        trained, az_batch(stats["replay"], batch_size, MAIN_SEED), label)
    step_ms, timed_losses = [], []
    for i in range(TIMED_LEARN_STEPS):
        batch = az_batch(stats["replay"], batch_size, MAIN_SEED + 1 + i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tstate, logs = trained.forward_learn(tstate, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        timed_losses.append(float(logs["total_loss"]))
    launches = _build.launches[DESCENT]
    train = dict(phase=f"{label}_train", train_iter=stats["train_iter"],
                 env_steps=stats["env_steps"], replay=len(stats["replay"]),
                 logged_total_losses=losses, collect_steps_per_s=collect_sps, wall_s=train_wall,
                 learn_step_ms_median=float(np.median(step_ms)), learn_step_ms=step_ms,
                 card_vs_cpu=agreement_learn, launches=launches, card=card)
    emit(train)
    problems = [] if agree else [f"card and CPU learn steps disagree: {agreement_learn}"]
    if stats["train_iter"] != SHORT_TRAIN_ITERS:
        problems.append(f"train_iter {stats['train_iter']}, expected {SHORT_TRAIN_ITERS}")
    if not isinstance(trained, policy_cls) or not collect_sps:
        problems.append(f"train_alphazero built {type(trained).__name__}, collect {collect_sps}")
    if (not losses or not all(math.isfinite(x) for x in losses + timed_losses)
            or not all(bool(torch.isfinite(p).all()) for p in tstate.model.parameters())):
        problems.append("non-finite loss or params")
    if launches != 0:
        problems.append(f"{label}'s searches launched the descent kernel {launches} times")
    if problems:
        raise AssertionError(f"{label} failed: {problems}")
    return dict(card_vs_cpu=agreement, eval=ev, train=train, launches=launches,
                collect_steps_per_s=float(np.median(collect_sps)))


def chess_on_card(card: str) -> dict:
    """Chess AlphaZero at the zoo width (96 channels, 6 res blocks, 4672
    actions, 50 simulations): the eval against the rule bot on 5 envs, games
    cut at CHESS_MAX_MOVES plies, its descents timed; perft to depth 2 from
    the start position and Kiwipete with the card's legal_mask_full."""
    _build.launches[DESCENT] = 0
    cfg = az_board_config(chess_az_config, CHESS_MAX_MOVES)
    bot_env = build_env(cfg.env, "play_with_bot_mode")
    policy = AlphaZeroPolicy(cfg.policy, build_env(cfg.env, "self_play_mode"), device="cuda",
                             seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 71)
    sims = int(policy.cfg.num_simulations)
    descent, restore = timed_descents(puct, "_generic_traverse")
    try:
        # chunks of CHESS_MAX_MOVES batched steps: each game ends within one
        res = AlphaZeroBotEvaluator(bot_env, policy, 5, rollout_length=CHESS_MAX_MOVES,
                                    seed=MAIN_SEED).eval(5)
        torch.cuda.synchronize()
    finally:
        restore()
    ev = descent_record(dict(phase="chess_alphazero_eval", num_envs=5,
                             episode_returns=res["episode_returns"], env_steps=res["env_steps"],
                             max_moves=CHESS_MAX_MOVES, wall_s=res["duration"],
                             wall_per_env_step_s=res["duration"] / res["env_steps"],
                             launches=_build.launches[DESCENT], card=card), descent)
    emit(ev)
    if (len(res["episode_returns"]) != 5 or descent["calls"] != res["env_steps"] * sims
            or ev["launches"] != 0):
        raise AssertionError(f"chess eval: {res['episode_returns']}, {descent['calls']} descents "
                             f"for {res['env_steps']} steps x {sims}, {ev['launches']} launches")
    perfts = []
    for name, fen, depth, expected in PERFT_CASES:
        s = chess.state_from_fen(fen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nodes = chess.perft(s.board, s.castling, s.ep_sq, s.to_play == 1, depth)
        perfts.append(dict(position=name, depth=depth, nodes=nodes, expected=expected,
                           wall_s=time.perf_counter() - t0))
        if nodes != expected:
            raise AssertionError(f"chess perft {name} depth {depth}: {nodes} != {expected}")
    rec = dict(phase="chess_perft", cases=perfts, device=str(s.board.device), card=card)
    emit(rec)
    return dict(eval=ev, perft=rec, launches=ev["launches"])


def gomoku_muzero_on_card(card: str) -> dict:
    """Gomoku MuZero (conv 32 channels, 36 actions, 50 simulations, bot
    mode) with downsample=False (the zoo config's default downsampling
    leaves no cell of the 6x6 board, and the JAX package fails on it:
    ROADMAP queue 3), seeded weights: the Evaluator against the rule bot on
    3 envs with its generic descent timed, a short train_muzero run at
    BIG_MZ_TRAIN_SIMS simulations; no launch."""
    cfg = copy.deepcopy(gomoku_mz_config)
    cfg.policy.model.downsample = False
    policy = MuZeroPolicy(cfg.policy, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 81)
    sims = policy.search_cfg.num_simulations
    env = create_env(cfg.env)
    descent, restore = timed_descents(puct, "_generic_traverse")
    try:
        ev = eval_episodes(policy, card, "gomoku_muzero", env=env, returns_range=(-1.0, 1.0))
    finally:
        restore()
    ev = descent_record(dict(ev, config="gomoku_muzero_bot_mode", num_simulations=sims), descent)
    emit(ev)
    if ev["launches"] != 0 or descent["calls"] != ev["env_steps"] * sims:
        raise AssertionError(f"gomoku_muzero eval: {ev['launches']} launches, "
                             f"{descent['calls']} descents for {ev['env_steps']} steps x {sims}")
    cfg.policy.num_simulations = BIG_MZ_TRAIN_SIMS
    cfg.env.evaluator_env_num = cfg.env.n_evaluator_episode = 3
    train, problems, *_ = short_train(cfg, card, "gomoku_muzero", 0)
    train.update(collect_steps_per_s=float(np.median(train["collect_steps_per_s"])))
    emit(train)
    if problems:
        raise AssertionError(f"gomoku_muzero train failed: {problems}")
    return dict(eval=ev, train=train, launches=ev["launches"] + train["launches"])


def phase_big_boards(card: str) -> tuple:
    """Go 6x6 AlphaZero, Gomoku Gumbel and Sampled AlphaZero, Chess
    AlphaZero and Gomoku MuZero at the zoo configs' full width: every search
    has two players (or bot-mode roots), so each takes the generic or the
    Gumbel descent and none launches the kernel."""
    t0 = time.perf_counter()
    records = {}
    records["go6_alphazero"] = az_board_run(
        card, "go6_alphazero", az_board_config(go6_az_config, GO_MAX_MOVES), AlphaZeroPolicy,
        "_generic_traverse", lambda legal: dict(noise=dirichlet_on(legal, MAIN_SEED + 61)))
    gumbel_sims = int(gomoku_gaz_config.policy.num_simulations)
    records["gomoku_gumbel_alphazero"] = az_board_run(
        card, "gomoku_gumbel_alphazero", az_board_config(gomoku_gaz_config),
        GumbelAlphaZeroPolicy, "_gumbel_traverse",
        lambda legal: dict(gumbel=gumbel_draws(tuple(legal.shape), MAIN_SEED + 62)),
        # the improved policy: the root values' bound times the completed-Q
        # scale (maxvisit_init 50 + visits) * value_scale 0.1
        close=("visit_counts",), tol=VALUE_TOL * (50 + gumbel_sims) * 0.1)
    sampled_sims = int(gomoku_saz_config.policy.num_simulations)
    records["gomoku_sampled_alphazero"] = az_board_run(
        card, "gomoku_sampled_alphazero", az_board_config(gomoku_saz_config),
        SampledAlphaZeroPolicy, "_generic_traverse",
        lambda legal: dict(noise=dirichlet_on(legal, MAIN_SEED + 63),
                           root_gumbel=gumbel_draws(tuple(legal.shape), MAIN_SEED + 64),
                           sim_gumbel=gumbel_draws((sampled_sims,) + tuple(legal.shape),
                                                   MAIN_SEED + 65)))
    records["chess_alphazero"] = chess_on_card(card)
    records["gomoku_muzero"] = gomoku_muzero_on_card(card)
    for name, rec in records.items():
        ev = rec["eval"]
        emit(dict(phase=f"{name}_summary", card=card,
                  eval_s_per_env_step=ev["wall_per_env_step_s"],
                  descent_ms_per_call=ev["descent_ms_per_call"],
                  descent_levels_per_call=ev["descent_levels_per_call"],
                  descent_share_of_eval_wall=ev["descent_share_of_wall"],
                  learn_step_ms_median=rec.get("train", {}).get("learn_step_ms_median"),
                  collect_steps_per_s=rec.get("collect_steps_per_s",
                                              rec.get("train", {}).get("collect_steps_per_s")),
                  launches=rec["launches"]))
        if rec["launches"] != 0:
            raise AssertionError(f"{name}: the descent kernel was launched {rec['launches']} times")
    return records, time.perf_counter() - t0


def cache_bytes_per_node(policy) -> int:
    """The bytes of one tree node's KV cache: k and v (L, H, Tc, Dh) float32,
    the slots' positions (Tc) and the next position, int64."""
    cache = policy.init_collect_state(1)
    return sum(t.numel() * t.element_size() for t in cache)


def uz_context_card_vs_cpu(policy, env_cls) -> dict:
    """UZ_CONTEXT_STEPS stateful steps of 4 grid envs on the card and on the
    CPU from the same weights and an empty context, with tie_break='first':
    eval steps (the same argmax actions, so the contexts stay alike), then a
    collect step with the same Dirichlet noise. At each step the visit counts
    equal and the searched and predicted root values within VALUE_TOL; the
    contexts' slot positions equal."""
    B, A = 4, env_cls.action_space_size
    g = torch.Generator().manual_seed(MAIN_SEED + 15)
    env = env_cls()
    state, obs = env.reset(B, g)
    frames = []
    for _ in range(UZ_CONTEXT_STEPS):
        frames.append(obs)
        step = env.step(state, torch.randint(0, A, (B,), generator=g), g)
        state, obs = step.state, step.obs
    legal = torch.ones((B, A), dtype=torch.bool)
    to_play = torch.full((B,), -1, dtype=torch.int32)
    noise = torch.from_numpy(np.random.default_rng(MAIN_SEED + 15).dirichlet(
        np.full(A, 0.3), B).astype(np.float32))
    cpu_policy = type(policy)(policy.cfg, model=copy.deepcopy(policy.model).cpu(), device="cpu")
    search_cfg = policy.search_cfg
    runs = []
    try:
        for p in (policy, cpu_policy):
            p.search_cfg = dataclasses.replace(search_cfg, tie_break="first")
            d, context, run = p.device, p.init_collect_state(B), []
            for t, o in enumerate(frames):
                collect = t == len(frames) - 1
                out, context = p._forward_collect_stateful(
                    o.to(d), legal.to(d), to_play.to(d), 1.0, 0.0, context,
                    deterministic=not collect, noise=noise.to(d) if collect else None)
                run.append(dict({k: out[k].cpu() for k in
                                 ("visit_counts", "searched_value", "predicted_value")},
                                pos=context.pos.cpu()))
            runs.append(run)
    finally:
        policy.search_cfg = search_cfg
    err = {k: max(float((a[k] - b[k]).abs().max()) for a, b in zip(*runs))
           for k in ("searched_value", "predicted_value")}
    rec = dict(phase="unizero_context_card_vs_cpu", batch=B, steps=UZ_CONTEXT_STEPS,
               tie_break="first", visit_counts=[r["visit_counts"].tolist() for r in runs[0]],
               max_abs_err=err)
    emit(rec)
    for t, (a, b) in enumerate(zip(*runs)):
        for key in ("visit_counts", "pos"):
            if not torch.equal(a[key], b[key]):
                raise AssertionError(f"unizero: card and CPU {key} differ at step {t}")
        for key in ("searched_value", "predicted_value"):
            if not (torch.isfinite(a[key]).all()
                    and torch.allclose(a[key], b[key], rtol=VALUE_TOL, atol=VALUE_TOL)):
                raise AssertionError(f"unizero: card and CPU {key} differ at step {t}: "
                                     f"{a[key].tolist()} vs {b[key].tolist()}")
    return rec


def phase_unizero(card: str, l2_ns: float) -> tuple:
    """UniZero on Grid Breakout at the ws config's full width (conv 64, embed
    256, 2 layers, 8 heads, 24 tokens, 25 simulations, batch 256, drift
    correction of depth 2, group_kl) and Sampled UniZero on Pendulum (K=16,
    50 simulations), random weights from seed 0: every search keeps a KV
    cache per node and launches the descent kernel once a simulation
    (prefetch route at A=3, row read at K=16)."""
    t0 = time.perf_counter()
    records, cases = {}, []
    for i, (label, policy_cls, config, env_cls, eval_steps, train_steps, captured) in enumerate((
            ("unizero", UniZeroPolicy, uz_ws_config, BreakoutGridEnv, UZ_EVAL_STEPS,
             UZ_TRAIN_EPISODE_STEPS, UZ_CAPTURED_SIMS),
            ("sampled_unizero", SampledUniZeroPolicy, suz_config, PendulumEnv, SUZ_EVAL_STEPS,
             SUZ_TRAIN_EPISODE_STEPS, SUZ_CAPTURED_SIMS))):
        policy = policy_cls(config.policy, device="cuda", seed=MAIN_SEED)
        randomize_heads(policy.model, MAIN_SEED + 15 + i)
        sims = policy.search_cfg.num_simulations
        sampled = policy_cls is SampledUniZeroPolicy
        width = policy.K if sampled else env_cls.action_space_size
        if sampled:
            env, returns_range = (PendulumEnv(max_episode_steps=eval_steps),
                                  (-17.0 * eval_steps, 0.0))
        else:
            env, returns_range = BreakoutGridEnv(max_steps=eval_steps), (0.0, float(eval_steps))
        ev = eval_episodes(policy, card, label, env=env, returns_range=returns_range)
        ev.update(config=("pendulum_sampled_unizero" if sampled else "breakout_grid_unizero_ws"),
                  num_simulations=sims, A=width, route=kernel_route(width),
                  episodes_truncated_at=eval_steps, cache_bytes_per_node=cache_bytes_per_node(policy))
        emit(ev)
        if ev["launches"] != ev["env_steps"] * sims:
            raise AssertionError(f"{label}: traverse launches {ev['launches']} != env steps "
                                 f"{ev['env_steps']} x {sims}")
        if sampled:
            agreement = sampled_search_card_vs_cpu(policy, label)
            obs = PendulumEnv().reset(3, torch.Generator().manual_seed(MAIN_SEED))[1]
            legal = torch.ones((3, 1), dtype=torch.bool)
        else:
            agreement = uz_context_card_vs_cpu(policy, env_cls)
            obs, legal = grid_states(env_cls(), 3, MAIN_SEED + 25)
        captures = capture_descent_inputs(policy, obs.cuda(), legal.cuda(), captured)
        if sorted(captures) != list(captured):
            raise AssertionError(f"captured simulations {sorted(captures)}, expected {captured}")
        cases += phase_captured(captures, l2_ns, search=f"{label} eval search")

        cfg = copy.deepcopy(config)
        if sampled:
            cfg.env.max_episode_steps = train_steps
            cfg.env.stop_value = 1.0  # out of reach: a return is at most 0
        else:
            cfg.env.max_steps = train_steps
            cfg.policy.train_start_after_envsteps = 0
        cfg.policy.num_simulations = SHORT_TRAIN_SIMS
        train, problems, _, state, buffer = short_train(cfg, card, label,
                                                        cfg.policy.num_simulations,
                                                        timed_steps=UZ_TIMED_LEARN_STEPS)
        train.update(episodes_truncated_at=train_steps)
        emit(train)
        if problems:
            raise AssertionError(f"{label} train failed: {problems}")
        # the run's buffer and target net feed phase 18's LPIPS learn steps
        records[label] = dict(eval=ev, card_vs_cpu=agreement, train=train, buffer=buffer,
                              target_model=state.target_model)
    wall = time.perf_counter() - t0
    emit(dict(phase="unizero_summary", wall_s=wall, card=card, **{
        f"{label}_{key}": value for label, rec in records.items() for key, value in (
            ("eval_s_per_env_step", rec["eval"]["wall_per_env_step_s"]),
            ("learn_step_ms", rec["train"]["learn_step_ms_median"]),
            ("collect_steps_per_s", rec["train"]["collect_steps_per_s"]),
            ("cache_bytes_per_node", rec["eval"]["cache_bytes_per_node"]))}))
    return records, cases, wall


@contextlib.contextmanager
def recorded_mt_workers():
    """The multitask entries' collectors and evaluators for phase 16: each
    collect round MT_COLLECT_STEPS batched steps, and every collect and eval
    recorded with its task (the entries build the workers in task order)."""
    records = dict(collects=[], evals=[])
    made = dict(collect=0, eval=0)

    class Collector(RolloutCollector):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, rollout_length=MT_COLLECT_STEPS, **kwargs)
            self.task, made["collect"] = made["collect"], made["collect"] + 1

        def collect(self, *args, **kwargs):
            out = super().collect(*args, **kwargs)
            records["collects"].append(dict(task=self.task, steps=out[2]["steps"],
                                            steps_per_s=out[2]["steps_per_sec"]))
            return out

    class RecordedEvaluator(Evaluator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.task, made["eval"] = made["eval"], made["eval"] + 1

        def eval(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = super().eval(*args, **kwargs)
            torch.cuda.synchronize()
            records["evals"].append(dict(task=self.task, env_steps=res["env_steps"],
                                         seconds=time.perf_counter() - t0))
            return res

    saved = [(m, m.RolloutCollector, m.Evaluator) for m in MT_ENTRY_MODULES]
    try:
        for m in MT_ENTRY_MODULES:
            m.RolloutCollector, m.Evaluator = Collector, RecordedEvaluator
        yield records
    finally:
        for m, collector, evaluator in saved:
            m.RolloutCollector, m.Evaluator = collector, evaluator


def mt_run(label: str, entry_fn, cfgs: list, card: str) -> tuple:
    """A multitask entry with the device left unset (the card) for an eval
    at iter 0, a collect round per task and SHORT_TRAIN_ITERS learn steps,
    the launch counter read around it: (record, problems, policy, state,
    stats). Launches = the sum over tasks of (eval + collect searches) x
    simulations."""
    cfgs = copy.deepcopy(cfgs)
    with tempfile.TemporaryDirectory() as tmp, recorded_mt_workers() as workers:
        for c in cfgs:
            c.exp_name = os.path.join(tmp, label)
            c.env.max_episode_steps = MT_EPISODE_STEPS
            c.policy.update_per_collect = SHORT_TRAIN_ITERS
        _build.launches[DESCENT] = 0
        t0 = time.perf_counter()
        policy, state, stats = entry_fn(cfgs, seed=MAIN_SEED, max_train_iter=SHORT_TRAIN_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _build.launches[DESCENT]
        with open(os.path.join(tmp, label, "log", "train.jsonl")) as f:
            losses = [json.loads(line)["learner/total_loss"] for line in f
                      if "learner/total_loss" in line]
    sims = policy.search_cfg.num_simulations
    searches = {t: stats["eval_env_steps"][t]
                + stats["task_env_steps"][t] // int(cfgs[t].env.collector_env_num)
                for t in stats["task_env_steps"]}
    expected = sum(searches.values()) * sims
    eval_s = {t: sum(r["seconds"] for r in workers["evals"] if r["task"] == t)
              / max(1, sum(r["env_steps"] for r in workers["evals"] if r["task"] == t))
              for t in searches}
    rec = dict(phase=f"{label}_train", tasks=len(cfgs), policy_type=cfgs[0].policy.type,
               train_iter=stats["train_iter"], num_simulations=sims, searches=searches,
               launches=launches, expected_launches=expected, logged_total_losses=losses,
               eval_s_per_env_step=eval_s,
               collect_steps_per_s=[r["steps_per_s"] for r in workers["collects"]],
               episodes_truncated_at=MT_EPISODE_STEPS, collect_round_steps=MT_COLLECT_STEPS,
               wall_s=wall, card=card)
    problems = []
    if stats["train_iter"] != SHORT_TRAIN_ITERS:
        problems.append(f"train_iter {stats['train_iter']}, expected {SHORT_TRAIN_ITERS}")
    if launches != expected:
        problems.append(f"traverse launches {launches} != (eval + collect searches) x {sims} "
                        f"= {expected}")
    if not losses or not all(math.isfinite(x) for x in losses) or not all(
            bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        problems.append("non-finite loss or params")
    return rec, problems, policy, state, stats


def mt_batches(policy, state, buffers: dict, n: int) -> list:
    """n combined multitask batches of the buffers' samples (every task's
    rows, unit task weights), on the card."""
    per = int(policy.cfg.batch_size) // policy.task_num
    order = sorted(buffers)
    weights = np.ones(policy.task_num, np.float32)
    return [combine_task_batches([buffers[t].sample(per, state.target_model)[0] for t in order],
                                 order, per, weights, True) for _ in range(n)]


def timed_steps(policy, state, batches: list) -> list:
    """CUDA events around each learn step: ms."""
    ms = []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _, _ = policy.forward_learn(state, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


def stage_switch_on_card(policy, batch, card: str) -> dict:
    """``set_curriculum_stage(1)`` on a copy of the policy, then one learn
    step on the card: the transformer backbone (its base weights and task
    embedding) bit-unchanged, the stage-1 adapters moved (their B factors:
    the A factors' gradient is zero while B is at its zero init)."""
    p = type(policy)(policy.cfg, model=copy.deepcopy(policy.model), device="cuda")
    state = p.set_curriculum_stage(1, p.init_train_state())
    before = {n: v.detach().clone() for n, v in p.model.named_parameters()}
    state, logs, _ = p.forward_learn(state, batch)
    torch.cuda.synchronize()
    after = dict(p.model.named_parameters())
    frozen = [n for n in before if n.startswith("transformer.") and "lora_" not in n
              and "_scale" not in n]
    adapters = [n for n in before if "lora_B_1" in n]
    rec = dict(phase="scalezero_stage_switch", stage=p.model.tcfg.curriculum_stage,
               frozen_tensors=len(frozen),
               frozen_unchanged=all(torch.equal(after[n], before[n]) for n in frozen),
               adapter_tensors=len(adapters),
               adapters_moved=all(not torch.equal(after[n], before[n]) for n in adapters),
               total_loss=float(logs["total_loss"]), card=card)
    emit(rec)
    if not (rec["stage"] == 1 and frozen and adapters and rec["frozen_unchanged"]
            and rec["adapters_moved"]):
        raise AssertionError(f"stage switch: {rec}")
    return rec


def ddp_on_card(card: str) -> dict:
    """``ddp_learn_step`` in a one-rank NCCL group (a FileStore in a temp
    dir) against the plain learn step, with the CartPole MuZero config's
    policy from the same seed, on a numpy-seeded batch."""
    cfg = main_config.policy
    batch = batch_to(random_batch(int(cfg.batch_size), 5, 2, seed=MAIN_SEED + 16), "cuda")
    policies = []
    for _ in range(2):
        p = MuZeroPolicy(cfg, device="cuda", seed=MAIN_SEED)
        randomize_heads(p.model, MAIN_SEED + 16)
        policies.append(p)
    # a one-rank group on one card reaches no peer over InfiniBand or NVLink
    # SHARP, so both are off (this whole check took 1.3-2.0 s on three H100
    # hosts and 39 s on a fourth with both at NCCL's defaults; the timings
    # below say where such time goes)
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    os.environ.setdefault("NCCL_NVLS_ENABLE", "0")
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        seconds["init"] = time.perf_counter() - t0
        try:
            backend = dist.get_backend()
            _, logs, prio = policies[0].forward_learn(policies[0].init_train_state(), batch)
            t0 = time.perf_counter()
            _, ddp_logs, ddp_prio = ddp_learn_step(policies[1], policies[1].init_train_state(),
                                                   batch)
            torch.cuda.synchronize()
            seconds["ddp_step"] = time.perf_counter() - t0
        finally:
            t0 = time.perf_counter()
            dist.destroy_process_group()
            seconds["destroy"] = time.perf_counter() - t0
    pairs = [(a.detach(), b.detach())
             for a, b in zip(policies[0].model.parameters(), policies[1].model.parameters())]
    rec = dict(phase="ddp_nccl_world_1", backend=backend, batch=int(cfg.batch_size),
               seconds=seconds,
               bit_equal=all(torch.equal(a, b) for a, b in pairs) and torch.equal(prio, ddp_prio),
               param_max_abs_err=max(float((a - b).abs().max()) for a, b in pairs),
               priority_max_abs_err=float((prio - ddp_prio).abs().max()),
               max_log_rel_err=max(abs(float(ddp_logs[k]) - float(v)) / max(abs(float(v)), 1e-6)
                                   for k, v in logs.items()),
               card=card)
    emit(rec)
    if not (rec["param_max_abs_err"] <= LEARN_PARAM_ATOL and rec["max_log_rel_err"] <= 1e-6
            and rec["priority_max_abs_err"] <= VALUE_TOL and not dist.is_initialized()):
        raise AssertionError(f"ddp_learn_step at world size 1 differs from the plain step: {rec}")
    return rec


def phase_multitask(card: str, l2_ns: float) -> tuple:
    """ScaleZero v3 at full width (3 tasks, embed 256, 2 layers, 8 heads, 22
    tokens, K=20, 25 simulations, batch 96, unroll 10, LoRA r=4 over 2
    stages) through train_multitask_balance, random weights from seed 0:
    every task view's search launches the descent kernel once a simulation
    (row-read route, A=K=20). Then its captured tables, its task views and
    learn steps (default and CAGrad) card vs CPU, a forced stage switch, the
    CartPole + Pendulum balance config and the smoke's own two-task CartPole
    muzero_multitask run (prefetch route, A=2), and ddp_learn_step on NCCL."""
    t0 = time.perf_counter()
    cases, records = [], {}
    rec, problems, policy, state, stats = mt_run("scalezero_v3", train_multitask_balance,
                                                 scalezero_v3, card)
    width = dict(embed_dim=policy.model.embed_dim, num_heads=policy.model.num_heads,
                 K=policy.K, batch_size=int(policy.cfg.batch_size), tasks=policy.task_num,
                 num_simulations=policy.search_cfg.num_simulations)
    rec.update(width, route=kernel_route(policy.K))
    emit(rec)
    if width != dict(embed_dim=256, num_heads=8, K=20, batch_size=96, tasks=3,
                     num_simulations=25):
        problems.append(f"not ScaleZero v3's width: {width}")
    if problems:
        raise AssertionError(f"scalezero_v3 run failed: {problems}")
    records["scalezero_v3"] = rec
    view = policy.task_view(0)
    obs = PendulumEnv().reset(2, torch.Generator().manual_seed(MAIN_SEED))[1]
    captures = capture_descent_inputs(view, obs.cuda(), torch.ones((2, 1), dtype=torch.bool).cuda(),
                                      MT_CAPTURED_SIMS)
    if sorted(captures) != list(MT_CAPTURED_SIMS):
        raise AssertionError(f"captured simulations {sorted(captures)}, expected "
                             f"{MT_CAPTURED_SIMS}")
    cases += phase_captured(captures, l2_ns, search="scalezero task-0 eval search")
    records["task_views"] = [sampled_search_card_vs_cpu(policy.task_view(t), f"scalezero_task{t}")
                             for t in range(policy.task_num)]
    batches = mt_batches(policy, state, stats["buffers"], MT_TIMED_LEARN_STEPS + 1)
    default, agree = learn_step_card_vs_cpu(policy, batches[0])
    cagrad_policy = type(policy)(deep_merge(policy.cfg, dict(grad_correction="cagrad")),
                                 model=copy.deepcopy(policy.model), device="cuda")
    cagrad, agree_cagrad = learn_step_card_vs_cpu(
        cagrad_policy, batches[0],
        log_atol={f"task{t}_cagrad_w": CAGRAD_W_ATOL for t in range(policy.task_num)})
    w_sum = sum(cagrad["log_abs_values"].values())
    if not (agree and agree_cagrad and abs(w_sum - 1.0) < 1e-5):
        raise AssertionError(f"scalezero learn steps card vs CPU: default {default}, "
                             f"CAGrad {cagrad} (weights sum {w_sum})")
    default_ms = timed_steps(policy, state, batches[1:])
    cagrad_ms = timed_steps(cagrad_policy, cagrad_policy.init_train_state(),
                            batches[1:1 + MT_TIMED_CAGRAD_STEPS])
    records["learn"] = dict(default=default, cagrad=cagrad, default_ms=default_ms,
                            cagrad_ms=cagrad_ms)
    records["stage_switch"] = stage_switch_on_card(policy, batches[0], card)
    del policy, state, stats, cagrad_policy, batches

    # the balance and muzero_multitask runs check launches and finite
    # losses only: they search with SHORT_TRAIN_SIMS (25, then 10, until
    # phase 17 came)
    records["balance"], problems, *_ = mt_run(
        "balance_cartpole_pendulum", train_multitask_balance,
        [with_sims(c, SHORT_TRAIN_SIMS) for c in balance_tasks], card)
    emit(records["balance"])
    # the smoke's own two-task CartPole run: the task layout of
    # tests/test_entries_extra.py's multitask smoke (stop values 195 and
    # 150, 2 collect and 2 eval envs, one episode a round, batch 16) at the
    # CartPole MuZero config's model width and 25 simulations
    mz = []
    for stop in (195, 150):
        c = copy.deepcopy(main_config)
        c.env.update(stop_value=stop, collector_env_num=2, evaluator_env_num=2,
                     n_evaluator_episode=2)
        c.policy.update(type="muzero_multitask", batch_size=16, n_episode=1,
                        num_simulations=SHORT_TRAIN_SIMS)
        mz.append(c)
    records["muzero_multitask"], mz_problems, *_ = mt_run("muzero_multitask",
                                                           train_muzero_multitask, mz, card)
    emit(records["muzero_multitask"])
    if problems or mz_problems:
        raise AssertionError(f"multitask short runs failed: {problems + mz_problems}")
    records["ddp"] = ddp_on_card(card)
    wall = time.perf_counter() - t0
    sz = records["scalezero_v3"]
    emit(dict(phase="multitask_summary", wall_s=wall, card=card,
              scalezero_eval_s_per_env_step=sz["eval_s_per_env_step"],
              scalezero_learn_step_ms=float(np.median(default_ms)),
              scalezero_cagrad_learn_step_ms=float(np.median(cagrad_ms)),
              scalezero_collect_steps_per_s=sz["collect_steps_per_s"],
              balance_eval_s_per_env_step=records["balance"]["eval_s_per_env_step"],
              muzero_multitask_eval_s_per_env_step=records["muzero_multitask"][
                  "eval_s_per_env_step"]))
    return records, cases, wall


class StandInHostEnv:
    """The stand-in for a gymnasium env in phase 17: a vec env with
    HostVecEnv's interface (lightzero_tpu_torch/envs/host_env.py) over the
    port's CartPoleEnv, stepped on the CPU one env at a time and seeded as
    HostVecEnv seeds: env i's episodes start from seed + i, and each reset
    adds 10,000. It drives the host collector and evaluator on a machine
    without gymnasium; it is not part of the package."""

    observation_shape = 4
    action_space_size = 2
    continuous = False

    def __init__(self, num_envs: int, seed: int = 0, max_episode_steps: int = 200):
        self.num_envs = num_envs
        self.env = CartPoleEnv(max_episode_steps=max_episode_steps)
        self._seeds = [seed + i for i in range(num_envs)]
        self._states = [None] * num_envs

    def _generator(self, i: int) -> torch.Generator:
        return torch.Generator().manual_seed(self._seeds[i])

    def _legal(self) -> np.ndarray:
        return np.ones((self.num_envs, 2), bool)

    def reset_all(self):
        obs = []
        for i in range(self.num_envs):
            self._states[i], o = self.env.reset(1, self._generator(i))
            self._seeds[i] += 10_000
            obs.append(o[0].numpy())
        return np.stack(obs), self._legal(), np.full(self.num_envs, -1, np.int64)

    def step(self, actions):
        obs, rewards, dones = [], [], []
        for i in range(self.num_envs):
            # the step resets a finished episode from the env's next seed
            step = self.env.step(self._states[i], torch.as_tensor([int(actions[i])]),
                                 self._generator(i))
            done = bool(step.done[0])
            if done:
                self._seeds[i] += 10_000
            self._states[i] = step.state
            obs.append(step.obs[0].numpy())
            rewards.append(float(step.reward[0]))
            dones.append(done)
        return (np.stack(obs).astype(np.float32), np.asarray(rewards, np.float32),
                np.asarray(dones, bool), self._legal(), np.full(self.num_envs, -1, np.int64))


def host_libraries() -> dict:
    """Which of the host envs' libraries import here, with their versions
    (None where one does not import)."""
    import importlib.metadata

    found = {}
    for name, dist in (("gymnasium", "gymnasium"), ("Box2D", "box2d"), ("mujoco", "mujoco"),
                       ("dm_control", "dm_control")):
        try:
            mod = importlib.import_module(name)
        except Exception:
            found[name] = None
            continue
        try:
            found[name] = importlib.metadata.version(dist)
        except importlib.metadata.PackageNotFoundError:
            found[name] = getattr(mod, "__version__", "imported (version unknown)")
    return found


@contextlib.contextmanager
def recorded_host_workers():
    """Every HostEvaluator.eval (seconds and batched steps, the device
    synchronised around it) and HostCollector.collect (its stats) while the
    block runs."""
    records = dict(evals=[], collects=[])
    evaluate, collect = HostEvaluator.eval, HostCollector.collect

    def timed_eval(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate(self, *args, **kwargs)
        torch.cuda.synchronize()
        records["evals"].append(dict(env_steps=res["env_steps"],
                                     seconds=time.perf_counter() - t0))
        return res

    def recorded_collect(self, *args, **kwargs):
        out = collect(self, *args, **kwargs)
        records["collects"].append(dict(steps=out[2]["steps"], steps_per_s=out[2]["steps_per_sec"]))
        return out

    HostEvaluator.eval, HostCollector.collect = timed_eval, recorded_collect
    try:
        yield records
    finally:
        HostEvaluator.eval, HostCollector.collect = evaluate, collect


def host_figures(rec: dict, workers: dict) -> dict:
    """The host path's eval wall per batched env step and collect env steps/s."""
    steps = sum(r["env_steps"] for r in workers["evals"])
    rec.update(host_eval_s_per_env_step=sum(r["seconds"] for r in workers["evals"]) / steps,
               host_collect_steps_per_s=[r["steps_per_s"] for r in workers["collects"]])
    return rec


@contextlib.contextmanager
def standin_host_envs():
    """train_muzero's host path over StandInHostEnv: create_env gives None
    for every config, and make_host_vec_env the stand-in."""
    saved = TRAIN_MUZERO_MODULE.create_env, TRAIN_MUZERO_MODULE.make_host_vec_env
    TRAIN_MUZERO_MODULE.create_env = lambda env_cfg: None
    TRAIN_MUZERO_MODULE.make_host_vec_env = lambda env_cfg, n, seed: StandInHostEnv(n, seed)
    try:
        yield
    finally:
        TRAIN_MUZERO_MODULE.create_env, TRAIN_MUZERO_MODULE.make_host_vec_env = saved


def host_eval_card_vs_cpu(policy) -> dict:
    """The first HOST_COMPARED_STEPS batched steps of HostEvaluator over the
    stand-in (3 envs, seed MAIN_SEED + 777), on the card and on the CPU from
    the same weights: each step's actions and visit counts equal, its
    searched values within VALUE_TOL."""
    steps = {}
    for dev in ("cuda", "cpu"):
        p = policy if dev == "cuda" else type(policy)(
            policy.cfg, model=copy.deepcopy(policy.model).cpu(), device="cpu")
        evaluator = HostEvaluator(StandInHostEnv(3, MAIN_SEED + 777), p, device=dev)
        seen = steps[dev] = []
        search = evaluator._search

        def recorded(*args, search=search, seen=seen, **kwargs):
            out, state = search(*args, **kwargs)
            seen.append(out)
            return out, state

        evaluator._search = recorded
        evaluator.eval(n_episodes=10 ** 6, max_steps=HOST_COMPARED_STEPS)
    err = 0.0
    for t, (card, cpu) in enumerate(zip(steps["cuda"], steps["cpu"])):
        for key in ("action", "visit_counts"):
            if not np.array_equal(card[key], cpu[key]):
                raise AssertionError(f"host eval step {t}: card and CPU differ in {key}: "
                                     f"{card[key].tolist()} vs {cpu[key].tolist()}")
        a, b = card["searched_value"], cpu["searched_value"]
        err = max(err, float(np.abs(a - b).max()))
        if not (np.isfinite(a).all() and np.allclose(a, b, rtol=VALUE_TOL, atol=VALUE_TOL)):
            raise AssertionError(f"host eval step {t}: card and CPU searched values differ: "
                                 f"{a.tolist()} vs {b.tolist()}")
    if len(steps["cuda"]) != HOST_COMPARED_STEPS or len(steps["cpu"]) != HOST_COMPARED_STEPS:
        raise AssertionError(f"compared {len(steps['cuda'])} and {len(steps['cpu'])} host eval "
                             f"steps, expected {HOST_COMPARED_STEPS}")
    rec = dict(phase="host_eval_card_vs_cpu", envs=3, steps=HOST_COMPARED_STEPS,
               searched_value_max_abs_err=err,
               actions=[s["action"].tolist() for s in steps["cuda"]])
    emit(rec)
    return rec


def host_short_train(cfg, card: str, label: str) -> dict:
    """short_train on a host config, its eval and collect figures recorded;
    the short run's problems raise."""
    with recorded_host_workers() as workers:
        rec, problems, policy, state, buffer = short_train(cfg, card, label,
                                                           int(cfg.policy.num_simulations),
                                                           halved_round=False)
    rec = host_figures(rec, workers)
    emit(rec)
    if problems:
        raise AssertionError(f"{label} failed: {problems}")
    return rec, policy, state, buffer


@contextlib.contextmanager
def timed_rnd():
    """The device time of every RNDRewardModel.train_step and estimate while
    the block runs (ms, CUDA events around each call)."""
    times = dict(train=[], estimate=[])
    saved = {name: getattr(RNDRewardModel, name) for name in ("train_step", "estimate")}

    def timed(name, fn):
        def call(self, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(self, *args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            times["train" if name == "train_step" else "estimate"].append(start.elapsed_time(end))
            return out
        return call

    for name, fn in saved.items():
        setattr(RNDRewardModel, name, timed(name, fn))
    try:
        yield times
    finally:
        for name, fn in saved.items():
            setattr(RNDRewardModel, name, fn)


def rnd_card_vs_cpu(model, state, obs: np.ndarray) -> dict:
    """One RND train step and one estimate on the card and on the CPU from
    the same weights and running statistics, on the same observations: the
    predictor's params within RND_RTOL of each tensor's largest magnitude
    where the gradient is more than GRAD_TO_ROUNDING times the two devices'
    rounding of it (Adam's first step, lr g / (|g| + eps), still carries a
    relative gradient error of up to 1 / GRAD_TO_ROUNDING where |g| is near
    eps), within 2 lr elsewhere (fewer than a quarter of them); the running
    count, mean and M2 within RND_RTOL relative; the intrinsic rewards,
    (error - mean) / std, within RND_RTOL of the errors' scale after the
    product with std (their difference from the mean cancels)."""
    results = {}
    rewards = np.zeros(len(obs), np.float32)
    for dev in ("cuda", "cpu"):
        m = RNDRewardModel(model.obs_dim, intrinsic_reward_weight=model.weight, device=dev)
        m.load_state_dict(model.state_dict())
        s = m.init_state()._replace(count=state.count.to(m.device), mean=state.mean.to(m.device),
                                    m2=state.m2.to(m.device), train_iter=state.train_iter)
        s, loss = m.train_step(s, obs)
        # copies: on the CPU .cpu() aliases the parameters, which the next
        # line overwrites
        grads = {k: p.grad.cpu().clone() for k, p in m.predictor.named_parameters()}
        params = {k: p.detach().cpu().clone() for k, p in m.predictor.named_parameters()}
        m.load_state_dict(model.state_dict())  # the estimate on the run's weights
        s, new, intr = m.estimate(s, obs, rewards)
        err = m.error(obs).detach().cpu()
        results[dev] = dict(loss=loss, grads=grads, params=params, intr=intr.cpu(),
                            new=new.cpu(), err=err,
                            stats={k: float(getattr(s, k)) for k in ("count", "mean", "m2")})
    card, cpu = results["cuda"], results["cpu"]
    lr = model.learning_rate
    tight, loose, n_loose, total = 0.0, 0.0, 0, 0
    for k, exp in cpu["params"].items():
        rel = (card["params"][k] - exp).abs() / exp.abs().max()
        rounding = (card["grads"][k] - cpu["grads"][k]).abs()
        sensitive = cpu["grads"][k].abs() <= GRAD_TO_ROUNDING * rounding
        if (~sensitive).any():
            tight = max(tight, float(rel[~sensitive].max()))
        if sensitive.any():
            loose = max(loose, float((card["params"][k] - exp).abs()[sensitive].max()))
        n_loose += int(sensitive.sum())
        total += sensitive.numel()
    stats_err = {k: abs(card["stats"][k] - v) / abs(v) for k, v in cpu["stats"].items()}
    std = {d: math.sqrt(max(r["stats"]["m2"] / r["stats"]["count"], 1e-8))
           for d, r in results.items()}
    intr_err = float((card["intr"] * std["cuda"] - cpu["intr"] * std["cpu"]).abs().max()
                     / cpu["err"].abs().max())
    rec = dict(phase="rnd_card_vs_cpu", observations=len(obs), loss_card=card["loss"],
               loss_cpu=cpu["loss"], param_max_rel_err=tight, param_max_abs_err_rounding=loose,
               rounding_bound_elements=n_loose, elements=total, stats_rel_err=stats_err,
               intrinsic_err_over_error_scale=intr_err,
               shaped_max_abs_err=float((card["new"] - cpu["new"]).abs().max()))
    emit(rec)
    if not (tight <= RND_RTOL and loose <= 2 * lr and n_loose < total // 4
            and max(stats_err.values()) <= RND_RTOL and intr_err <= RND_RTOL):
        raise AssertionError(f"RND card and CPU disagree: {rec}")
    return rec


def rnd_run(card: str, tmp: str) -> tuple:
    """The zoo's memory_muzero_rnd at full width through
    train_muzero_with_reward_model on the card, cut like phase 7 (an eval at
    iter 0, one collect round, of RND_COLLECT_STEPS batched steps, and
    SHORT_TRAIN_ITERS learn steps) at its 50 simulations, its exp dir under
    ``tmp``: launches = (collect + eval searches) x 50; its RND model card
    vs CPU; the learn step card vs CPU and timed. (record, the run's config)"""
    cfg = copy.deepcopy(rnd_config)
    cfg.exp_name = os.path.join(tmp, "memory_muzero_rnd")
    cfg.policy.update_per_collect = SHORT_TRAIN_ITERS
    _build.launches[DESCENT] = 0
    t0 = time.perf_counter()
    RND_ENTRY_MODULE.RolloutCollector = functools.partial(RolloutCollector,
                                                          rollout_length=RND_COLLECT_STEPS)
    try:
        with timed_rnd() as rnd_ms:
            policy, state, stats = train_muzero_with_reward_model(
                cfg, seed=MAIN_SEED, max_train_iter=SHORT_TRAIN_ITERS)
    finally:
        RND_ENTRY_MODULE.RolloutCollector = RolloutCollector
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launches[DESCENT]
    sims = policy.search_cfg.num_simulations
    n_envs = cfg.env.collector_env_num
    collect_searches = stats["env_steps"] // n_envs
    expected = (collect_searches + stats["eval_env_steps"]) * sims
    width = dict(latent_state_dim=policy.model.latent_state_dim, num_simulations=sims,
                 batch_size=int(policy.cfg.batch_size), num_unroll_steps=policy.num_unroll_steps)
    buffer = stats["buffer"]
    episodes = buffer._episodes
    obs = episodes[0].obs.reshape(len(episodes[0].obs), -1)
    rnd = rnd_card_vs_cpu(stats["reward_model"], stats["rnd_state"], obs)
    batch, _ = buffer.sample(int(policy.cfg.batch_size), state.target_model)
    agreement, agree = learn_step_card_vs_cpu(policy, batch)
    state, step_ms, _, timed_losses = time_learn_steps(policy, state, buffer, TIMED_LEARN_STEPS)
    rec = dict(phase="rnd_train", config="memory_muzero_rnd", width=width,
               train_iter=stats["train_iter"], env_steps=stats["env_steps"],
               collect_searches=collect_searches, eval_searches=stats["eval_env_steps"],
               collect_round_steps=RND_COLLECT_STEPS,
               launches=launches, expected_launches=expected, episodes=len(episodes),
               rnd_train_steps=stats["rnd_state"].train_iter,
               intrinsic_weight=stats["reward_model"].weight,
               rnd_train_ms_per_episode=float(np.median(rnd_ms["train"])),
               rnd_estimate_ms_per_episode=float(np.median(rnd_ms["estimate"])),
               rnd_train_ms=rnd_ms["train"], rnd_estimate_ms=rnd_ms["estimate"],
               learn_step_ms_median=float(np.median(step_ms)), learn_step_ms=step_ms,
               card_vs_cpu=agreement, rnd_card_vs_cpu=rnd, wall_s=wall, card=card)
    emit(rec)
    problems = [] if agree else [f"card and CPU learn steps disagree: {agreement}"]
    if width != dict(latent_state_dim=128, num_simulations=50, batch_size=256,
                     num_unroll_steps=12):
        problems.append(f"not memory_muzero_rnd's width: {width}")
    if stats["train_iter"] != SHORT_TRAIN_ITERS:
        problems.append(f"train_iter {stats['train_iter']}, expected {SHORT_TRAIN_ITERS}")
    if launches != expected:
        problems.append(f"traverse launches {launches} != (collect + eval searches) x {sims}")
    if not (stats["rnd_state"].train_iter == len(episodes) == len(rnd_ms["train"])
            == len(rnd_ms["estimate"])):
        problems.append(f"{len(rnd_ms['train'])} RND train steps and {len(rnd_ms['estimate'])} "
                        f"estimates for {len(episodes)} episodes")
    if not all(math.isfinite(x) for x in timed_losses) or not all(
            bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        problems.append("non-finite loss or params")
    if problems:
        raise AssertionError(f"RND run failed: {problems}")
    return rec, cfg


def eval_offline_on_card(cfg, card: str) -> dict:
    """eval_offline over the RND run's checkpoints on the card (the run
    writes ckpt_final only), the launch counter read around it: launches =
    eval searches x simulations."""
    evaluate = Evaluator.eval
    steps = []

    def counted(self, *args, **kwargs):
        res = evaluate(self, *args, **kwargs)
        steps.append(res["env_steps"])
        return res

    Evaluator.eval = counted
    _build.launches[DESCENT] = 0
    try:
        res = eval_offline(cfg, seed=MAIN_SEED, n_episodes=4)
    finally:
        Evaluator.eval = evaluate
    torch.cuda.synchronize()
    sims = int(cfg.policy.num_simulations)
    rec = dict(phase="eval_offline", results=res["results"], best_ckpt=res["best_ckpt"],
               eval_searches=sum(steps), launches=_build.launches[DESCENT],
               expected_launches=sum(steps) * sims, card=card)
    emit(rec)
    if list(res["results"]) != ["ckpt_final"] or not all(
            math.isfinite(v) for v in res["results"].values()):
        raise AssertionError(f"eval_offline swept {res['results']}, expected ckpt_final")
    if rec["launches"] != rec["expected_launches"]:
        raise AssertionError(f"eval_offline launches {rec['launches']} != eval searches x {sims}")
    return rec


def harmony_on_card(buffer, target_model, card: str) -> dict:
    """The CartPole MuZero config with harmony_balance at full width: one
    learn step card vs CPU (compare_learn_steps) on a batch of the stand-in
    run's buffer, with the scalars set off zero, then TIMED_LEARN_STEPS
    timed steps on the card, after which each scalar has moved."""
    cfg = deep_merge(main_config.policy, dict(model=dict(harmony_balance=True)))
    policy = MuZeroPolicy(cfg, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 5)
    with torch.no_grad():
        for name, h in zip(HARMONY_SCALARS, (0.3, -0.2, 0.1)):
            getattr(policy.model, name).fill_(h)
    batch, _ = buffer.sample(int(policy.cfg.batch_size), target_model)
    agreement, agree = learn_step_card_vs_cpu(policy, batch)
    state = policy.init_train_state()
    start = {k: float(getattr(policy.model, k).detach()) for k in HARMONY_SCALARS}
    state, step_ms, _, losses = time_learn_steps(policy, state, buffer, TIMED_LEARN_STEPS)
    moved = {k: float(getattr(policy.model, k).detach()) - start[k] for k in HARMONY_SCALARS}
    rec = dict(phase="harmony_learn", config="cartpole_muzero+harmony_balance",
               batch_size=int(policy.cfg.batch_size), card_vs_cpu=agreement,
               scalars_moved_by=moved, learn_step_ms_median=float(np.median(step_ms)),
               learn_step_ms=step_ms, card=card)
    emit(rec)
    if not agree:
        raise AssertionError(f"HarmonyDream learn steps card vs CPU disagree: {agreement}")
    if not all(v != 0.0 for v in moved.values()) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"HarmonyDream scalars did not move or losses not finite: {rec}")
    return rec


def phase_host(card: str, tensor_eval_s: float, tensor_collect_sps: list) -> tuple:
    """Phase 17: the host path, RND, eval_offline and HarmonyDream on the card."""
    t0 = time.perf_counter()
    records = {}
    libs = host_libraries()
    missing = [k for k, v in libs.items() if v is None]
    records["libraries"] = dict(phase="host_libraries", versions=libs, missing=missing)
    emit(records["libraries"])
    print("chip_smoke: host env libraries on this machine: " + ", ".join(
        f"{k} {v}" if v else f"{k} absent" for k, v in libs.items()), flush=True)

    # (b) the host collector and evaluator over the stand-in, at full width
    with standin_host_envs():
        rec, policy, state, buffer = host_short_train(main_config, card, "host_standin")
    rec.update(env="StandInHostEnv (CartPoleEnv on the CPU, HostVecEnv's seeding)",
               tensor_env_eval_s_per_env_step=tensor_eval_s,
               tensor_env_collect_steps_per_s=tensor_collect_sps)
    records["standin"] = rec
    emit(dict(phase="host_standin_vs_tensor_env", host_eval_s_per_env_step=rec[
        "host_eval_s_per_env_step"], tensor_env_eval_s_per_env_step=tensor_eval_s,
        host_collect_steps_per_s=rec["host_collect_steps_per_s"],
        tensor_env_collect_steps_per_s=tensor_collect_sps, card=card))
    seeded = MuZeroPolicy(main_config.policy, device="cuda", seed=MAIN_SEED)
    randomize_heads(seeded.model, MAIN_SEED + 1)
    records["standin_card_vs_cpu"] = host_eval_card_vs_cpu(seeded)

    # (c) the gymnasium configs, where their libraries import
    records["gymnasium"] = {}
    for name, config, needs in (("mtcar_muzero", mtcar_config, ("gymnasium",)),
                                ("lunarlander_disc_muzero", lunarlander_config,
                                 ("gymnasium", "Box2D"))):
        absent = [lib for lib in needs if libs[lib] is None]
        if absent:
            records["gymnasium"][name] = dict(phase=f"host_{name}", ran=False, absent=absent)
            emit(records["gymnasium"][name])
            print(f"chip_smoke: {name} did not run on the card: {', '.join(absent)} absent",
                  flush=True)
            continue
        cfg = with_sims(config, SHORT_TRAIN_SIMS)
        cfg.env.update(stop_value=1e9, env_kwargs=dict(max_episode_steps=HOST_EPISODE_STEPS))
        r, *_ = host_short_train(cfg, card, f"host_{name}")
        records["gymnasium"][name] = dict(r, ran=True)

    # (d) RND at full width, (f) eval_offline over its checkpoints
    with tempfile.TemporaryDirectory() as tmp:
        records["rnd"], rnd_cfg = rnd_run(card, tmp)
        records["eval_offline"] = eval_offline_on_card(rnd_cfg, card)

    # (e) HarmonyDream's learn step
    records["harmony"] = harmony_on_card(buffer, state.target_model, card)
    wall = time.perf_counter() - t0
    emit(dict(phase="host_summary", wall_s=wall, card=card, libraries=libs,
              standin_eval_s_per_env_step=rec["host_eval_s_per_env_step"],
              standin_collect_steps_per_s=rec["host_collect_steps_per_s"],
              tensor_env_eval_s_per_env_step=tensor_eval_s,
              tensor_env_collect_steps_per_s=tensor_collect_sps,
              gymnasium_configs={k: (dict(eval_s_per_env_step=v["host_eval_s_per_env_step"],
                                          collect_steps_per_s=v["host_collect_steps_per_s"],
                                          learn_step_ms=v["learn_step_ms_median"])
                                     if v["ran"] else "did not run")
                                 for k, v in records["gymnasium"].items()},
              rnd_learn_step_ms=records["rnd"]["learn_step_ms_median"],
              rnd_train_ms_per_episode=records["rnd"]["rnd_train_ms_per_episode"],
              rnd_estimate_ms_per_episode=records["rnd"]["rnd_estimate_ms_per_episode"],
              harmony_learn_step_ms=records["harmony"]["learn_step_ms_median"]))
    return records, wall


def timed_forward_learn(policy, batch, n: int) -> list:
    """ms of each of n learn steps on one batch (CUDA events), from a fresh
    optimizer over the policy's model."""
    state = policy.init_train_state()
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, logs, _ = policy.forward_learn(state, batch)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
        if not math.isfinite(float(logs["total_loss"])):
            raise AssertionError(f"non-finite LPIPS learn-step loss {logs}")
    return out


def lpips_learn_on_card(card: str, uz: dict, tmp: str) -> tuple:
    """(a) UniZero at the ws width with the reconstruction loss and the
    LPIPS term on a batch of phase 15's buffer (256 x 11 frames of 10x10x4):
    one learn step card vs CPU, lpips_distance card vs CPU on the first
    LPIPS_COMPARED_FRAMES frames, the learn step timed with and without
    the term, and the term's share of the step's device time from two
    torch.profiler passes (torch_trace), whose Chrome trace must hold CUDA
    kernels. (record, policy, batch)"""
    cfg = deep_merge(uz_ws_config.policy, dict(latent_recon_loss_weight=LPIPS_RECON_WEIGHT,
                                               perceptual_loss_weight=LPIPS_PERCEPTUAL_WEIGHT))
    policy = UniZeroPolicy(cfg, device="cuda", seed=MAIN_SEED)
    randomize_heads(policy.model, MAIN_SEED + 18)
    batch, _ = uz["buffer"].sample(int(cfg.batch_size), uz["target_model"])
    agreement, agree = learn_step_card_vs_cpu(policy, batch)
    frames = batch.obs.reshape((-1,) + tuple(batch.obs.shape[2:]))
    compared = frames[:LPIPS_COMPARED_FRAMES]
    other = torch.roll(compared, 1, dims=0)
    on_card = policy.lpips(compared, other)
    on_cpu = lpips_distance(compared.cpu(), other.cpu())
    lpips_err = float(((on_card.cpu() - on_cpu).abs() / on_cpu.abs().clamp(min=1e-6)).max())
    timed = UniZeroPolicy(cfg, model=copy.deepcopy(policy.model), device="cuda")
    plain = UniZeroPolicy(deep_merge(cfg, dict(perceptual_loss_weight=0.0)),
                          model=copy.deepcopy(policy.model), device="cuda")
    with_ms = timed_forward_learn(timed, batch, LPIPS_TIMED_STEPS)
    without_ms = timed_forward_learn(plain, batch, LPIPS_TIMED_STEPS)
    busy = {}
    for label, p in (("with", timed), ("without", plain)):
        state = p.init_train_state()
        with torch_trace(os.path.join(tmp, f"trace_{label}")) as prof:
            p.forward_learn(state, batch)
        busy[label] = device_busy(prof)["busy_us"]
    with open(os.path.join(tmp, "trace_with", "trace.json")) as f:
        trace_kernels = sum(1 for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel")
    rec = dict(phase="lpips_learn", config="breakout_grid_unizero_ws+lpips",
               latent_recon_loss_weight=LPIPS_RECON_WEIGHT,
               perceptual_loss_weight=LPIPS_PERCEPTUAL_WEIGHT, batch=int(cfg.batch_size),
               frames=int(frames.shape[0]), frame_shape=list(frames.shape[1:]),
               lpips_compared_frames=int(compared.shape[0]),
               card_vs_cpu=agreement, lpips_max_rel_err=lpips_err,
               lpips_mean=float(on_cpu.mean()),
               learn_step_ms_with_lpips=with_ms, learn_step_ms_without_lpips=without_ms,
               learn_step_ms_median_with_lpips=float(np.median(with_ms)),
               learn_step_ms_median_without_lpips=float(np.median(without_ms)),
               device_busy_us_with_lpips=busy["with"], device_busy_us_without_lpips=busy["without"],
               lpips_device_share=1.0 - busy["without"] / busy["with"],
               trace_kernel_events=trace_kernels, card=card)
    emit(rec)
    if not agree:
        raise AssertionError(f"LPIPS learn steps card vs CPU disagree: {agreement}")
    if not lpips_err <= LPIPS_RTOL or not bool(torch.isfinite(on_cpu).all()):
        raise AssertionError(f"lpips_distance card vs CPU {lpips_err} > {LPIPS_RTOL}")
    if trace_kernels == 0:
        raise AssertionError("torch_trace's Chrome trace holds no CUDA kernel")
    return rec, policy, batch


def landscape_on_card(policy, batch, card: str, tmp: str) -> dict:
    """(b) loss_landscape_api in 1-D at LANDSCAPE_POINTS points on the LPIPS
    policy and batch, on the card and on the CPU, on one direction drawn on
    the CPU from a seeded generator: the surfaces within LEARN_LOG_RTOL of
    each other, each model's parameters bit-unchanged."""
    direction = random_direction(copy.deepcopy(policy.model).cpu(),
                                 torch.Generator().manual_seed(MAIN_SEED))
    out, walls = {}, {}
    for dev in ("cuda", "cpu"):
        p = type(policy)(policy.cfg, model=copy.deepcopy(policy.model), device=dev)
        before = {k: v.clone() for k, v in p.model.state_dict().items()}
        d = {k: v.to(dev) for k, v in direction.items()}
        t0 = time.perf_counter()
        res = loss_landscape_api(p, p.model, batch_to(batch, p.device), os.path.join(tmp, dev),
                                 mode="1d", span=1.0, steps=LANDSCAPE_POINTS, render=dev == "cuda",
                                 directions=(d, d))
        walls[dev] = time.perf_counter() - t0
        after = p.model.state_dict()
        if not all(torch.equal(after[k], v) for k, v in before.items()):
            raise AssertionError(f"loss_landscape_api changed the {dev} model's parameters")
        out[dev] = res
    err = float(np.max(np.abs(out["cuda"]["loss"] - out["cpu"]["loss"])
                       / np.maximum(np.abs(out["cpu"]["loss"]), 1e-6)))
    rec = dict(phase="loss_landscape", points=LANDSCAPE_POINTS, alphas=out["cpu"]["alphas"].tolist(),
               loss_card=out["cuda"]["loss"].tolist(), loss_cpu=out["cpu"]["loss"].tolist(),
               max_rel_err=err, wall_s_card=walls["cuda"], wall_s_cpu=walls["cpu"],
               ms_per_point_card=1e3 * walls["cuda"] / LANDSCAPE_POINTS,
               rendered=[os.path.basename(x) for x in out["cuda"]["rendered"]], card=card)
    emit(rec)
    if not err <= LEARN_LOG_RTOL or not np.isfinite(out["cuda"]["loss"]).all():
        raise AssertionError(f"landscape card vs CPU {err} > {LEARN_LOG_RTOL}: {rec}")
    if np.ptp(out["cuda"]["loss"]) <= 0:
        raise AssertionError("the landscape is flat: the direction did not move the loss")
    return rec


def agent_on_card(card: str, tmp: str) -> dict:
    """(c) MuZeroAgent on the bundled gym_cartpole_v0 config at its full
    width (latent 128, 25 simulations, batch 256), on the card by default:
    train (an eval at iter 0, one collect round of SHORT_COLLECT_STEPS
    batched steps over twice the config's envs, AGENT_LEARN_STEPS learn
    steps), then deploy with replay, its CartPole episodes cut at
    AGENT_EPISODE_STEPS. Launches = (collect + eval searches)
    x 25 for train and deploy's env steps x 25; one replay per ended
    episode, its arrays of one length, episode_return their sum."""
    agent = MuZeroAgent("gym_cartpole_v0", exp_name=os.path.join(tmp, "agent"))
    agent.cfg.policy.update_per_collect = AGENT_LEARN_STEPS
    # the collect round halved as short_train halves it: SHORT_COLLECT_STEPS
    # batched steps over twice the config's envs; with episodes cut at
    # AGENT_EPISODE_STEPS every env ends one in the round, so the buffer
    # holds the batch of 256
    agent.cfg.env.collector_env_num *= 2
    agent.cfg.env.max_episode_steps = AGENT_EPISODE_STEPS
    sims = int(agent.cfg.policy.num_simulations)
    n_envs = int(agent.cfg.env.collector_env_num)
    TRAIN_MUZERO_MODULE.RolloutCollector = functools.partial(
        RolloutCollector, rollout_length=SHORT_COLLECT_STEPS)
    _build.launches[DESCENT] = 0
    t0 = time.perf_counter()
    try:
        stats = agent.train(max_env_step=1)
    finally:
        TRAIN_MUZERO_MODULE.RolloutCollector = RolloutCollector
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = _build.launches[DESCENT]
    expected_train = (stats["env_steps"] // n_envs + stats["eval_env_steps"]) * sims
    replay_dir = os.path.join(tmp, "replays")
    _build.launches[DESCENT] = 0
    t0 = time.perf_counter()
    res = agent.deploy(n_episodes=AGENT_DEPLOY_EPISODES, enable_save_replay=True,
                       replay_path=replay_dir)
    torch.cuda.synchronize()
    deploy_wall = time.perf_counter() - t0
    deploy_launches = _build.launches[DESCENT]
    problems = []
    lengths = []
    for i, ret in enumerate(res["episode_returns"]):
        rep = np.load(os.path.join(replay_dir, f"episode_{i}.npz"))
        T = len(rep["rewards"])
        lengths.append(T)
        if not (T > 0 and rep["obs"].shape[0] == T == rep["actions"].shape[0]):
            problems.append(f"replay {i}: lengths {rep['obs'].shape} {rep['actions'].shape} {T}")
        if not abs(float(rep["episode_return"]) - float(rep["rewards"].sum())) <= 1e-6 * max(T, 1):
            problems.append(f"replay {i}: episode_return is not the sum of its rewards")
        if float(rep["episode_return"]) != ret:
            problems.append(f"replay {i}: episode_return {float(rep['episode_return'])} != {ret}")
    replays = sorted(os.listdir(replay_dir))
    rec = dict(phase="agent", config="agent.BUNDLED_CONFIGS muzero gym_cartpole_v0",
               train_iter=stats["train_iter"], env_steps=stats["env_steps"],
               eval_searches=stats["eval_env_steps"], train_launches=train_launches,
               expected_train_launches=expected_train, train_wall_s=train_wall,
               deploy_env_steps=res["env_steps"], deploy_launches=deploy_launches,
               expected_deploy_launches=res["env_steps"] * sims, deploy_wall_s=deploy_wall,
               deploy_returns=res["episode_returns"], replay_files=len(replays),
               replay_lengths=lengths, card=card)
    emit(rec)
    if stats["train_iter"] != AGENT_LEARN_STEPS:
        problems.append(f"train_iter {stats['train_iter']} != {AGENT_LEARN_STEPS}")
    if train_launches != expected_train or deploy_launches != res["env_steps"] * sims:
        problems.append("launches differ from their formulas")
    if len(replays) != len(res["episode_returns"]) or len(replays) < AGENT_DEPLOY_EPISODES:
        problems.append(f"{len(replays)} replay files for {len(res['episode_returns'])} episodes")
    if problems:
        raise AssertionError(f"Agent on the card: {problems}")
    return rec


def small_checks_on_card(policy, batch, card: str, tmp: str) -> dict:
    """(d) augment_batch with injected draws, the analysis metrics on the
    batch's latents, card vs CPU; the gated Atari config ends in the
    adapter's ImportError on this machine (ale_py absent)."""
    frames = batch.obs[:, 0]
    rng = np.random.default_rng(MAIN_SEED)
    shifts = torch.from_numpy(rng.integers(0, 9, (frames.shape[0], 2)))
    noise = torch.from_numpy(rng.standard_normal(frames.shape[0]).astype(np.float32))
    aug = {dev: augment_batch(frames.to(dev), shifts=shifts, noise=noise).cpu()
           for dev in ("cuda", "cpu")}
    aug_err = float((aug["cuda"] - aug["cpu"]).abs().max())
    with torch.no_grad():
        latent = policy.model.train_forward(batch.obs, batch.actions)["obs_embeddings"][:, 0]
    metrics = {}
    for dev in ("cuda", "cpu"):
        x = latent.to(dev)
        metrics[dev] = dict(dormant_ratio=float(analysis.dormant_ratio(x)),
                            effective_rank=float(analysis.effective_rank(x)),
                            average_weight_magnitude=float(analysis.average_weight_magnitude(
                                {k: v.to(dev) for k, v in policy.model.named_parameters()})),
                            **{k: float(v) for k, v in analysis.latent_norm_stats(x).items()})
    metric_err = max(abs(metrics["cuda"][k] - v) / max(abs(v), 1e-6)
                     for k, v in metrics["cpu"].items())
    try:
        cfg = copy.deepcopy(atari_config)
        cfg.exp_name = os.path.join(tmp, "atari_muzero")
        train_muzero(cfg, max_env_step=1)
        gated = "ran"
    except ImportError as e:
        gated = f"ImportError: {e}"
    rec = dict(phase="small_checks", augment_max_abs_err=aug_err, metrics=metrics,
               metrics_max_rel_err=metric_err, atari_config=gated, card=card)
    emit(rec)
    if aug_err > 1e-6 or metric_err > ANALYSIS_RTOL or not gated.startswith("ImportError"):
        raise AssertionError(f"phase 18 small checks failed: {rec}")
    return rec


def phase_rest_of_item_20(card: str, uz: dict) -> tuple:
    """Phase 18: LPIPS in UniZero's learn step, the loss landscape, the
    Agent API with replay capture, augment, the analysis metrics and
    torch_trace on the card."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        lpips, policy, batch = lpips_learn_on_card(card, uz, tmp)
        landscape = landscape_on_card(policy, batch, card, tmp)
        agent = agent_on_card(card, tmp)
        small = small_checks_on_card(policy, batch, card, tmp)
    wall = time.perf_counter() - t0
    emit(dict(phase="rest_of_item_20_summary", wall_s=wall, card=card,
              lpips_learn_step_ms=lpips["learn_step_ms_median_with_lpips"],
              plain_learn_step_ms=lpips["learn_step_ms_median_without_lpips"],
              lpips_device_share=lpips["lpips_device_share"],
              landscape_ms_per_point=landscape["ms_per_point_card"],
              agent_train_wall_s=agent["train_wall_s"], agent_deploy_wall_s=agent["deploy_wall_s"]))
    return dict(lpips=lpips, landscape=landscape, agent=agent, small=small), wall


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU", file=sys.stderr)
        return 2
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(WATCHDOG_S)
    # backstop for a hang inside native code, where SIGALRM's handler cannot run
    faulthandler.dump_traceback_later(WATCHDOG_S + 5, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = phase_card()
    build = phase_build()
    l2_ns = phase_latency_probe(card)["l2_dependent_load_ns"]
    phase_division_check(card)
    cases = phase_kernel_vs_plain(l2_ns)
    backup_cases = phase_backup_vs_plain()
    norm_cases = phase_channel_norm()
    main_rec = phase_main_path(card)
    bench, captures = phase_bench_shape(card)
    cases += phase_captured(captures, l2_ns)
    train = phase_train(card)
    ez, ez_cases = phase_efficientzero(card, l2_ns)
    cases += ez_cases
    gmz = phase_gumbel(card)
    smz = phase_stochastic(card)
    sampled, sampled_cases = phase_sampled(card, l2_ns)
    cases += sampled_cases
    history, history_wall = phase_rezero_history(card)
    grid, grid_cases, grid_wall = phase_grid(card, l2_ns)
    cases += grid_cases
    probes, probe_cases, probes_wall = phase_probes(card, l2_ns)
    cases += probe_cases
    az, az_wall = phase_alphazero(card)
    c4, c4_wall = phase_connect4(card)
    big, big_wall = phase_big_boards(card)
    uz, uz_cases, uz_wall = phase_unizero(card, l2_ns)
    cases += uz_cases
    mt, mt_cases, mt_wall = phase_multitask(card, l2_ns)
    cases += mt_cases
    host, host_wall = phase_host(card, main_rec["wall_per_env_step_s"],
                                 train["collect_steps_per_s"])
    rest, rest_wall = phase_rest_of_item_20(card, uz["unizero"])

    main_case = next(c for c in cases if (c["B"], c["A"], c["N"], c["tie_break"]) == (3, 2, 26, "noise"))
    cell_backup = next(c for c in backup_cases if (c["search"], c["simulation"]) == ("cell", 25))
    moe_norm = next(c for c in norm_cases if c["label"] == "moe_learn.encoder")
    kernels = [dict(
        name="fused_traverse",
        route="cuda",
        source="lightzero_tpu_torch/csrc/fused_traverse.cu",
        replaces="lightzero_tpu/search/pallas_traverse.py:74",
        launches=main_rec["launches"],
        # the training path's run (train phase): collect and eval searches
        launches_train=train["launches"],
        # EfficientZero's eval (phase 7), whose search is the pUCT search
        launches_efficientzero=ez["eval"]["launches"],
        launches_efficientzero_train=ez["train"]["launches"],
        # Stochastic MuZero's eval and training (phase 9): the generic descent
        launches_stochastic_muzero=smz["eval"]["launches"],
        launches_stochastic_muzero_train=smz["train"]["launches"],
        # Sampled MuZero's and Sampled EfficientZero's evals and training
        # (phase 10): the row-read route, A = K = 20
        launches_sampled_muzero=sampled["sampled_muzero"]["eval"]["launches"],
        launches_sampled_muzero_train=sampled["sampled_muzero"]["train"]["launches"],
        launches_sampled_efficientzero=sampled["sampled_efficientzero"]["eval"]["launches"],
        launches_sampled_efficientzero_train=sampled["sampled_efficientzero"]["train"]["launches"],
        # phase 11: ReZero's training run (collect and eval searches and the
        # first search of each reuse group), its whole-buffer reuse
        # reanalyze alone, and the plain reanalyze of the trained buffer;
        # MuZero-Context's and MuZero-RNN's evals and training runs
        launches_rezero_train=history["rezero"]["train"]["launches"],
        launches_rezero_reanalyze=sum(c["launches"] for c in history["rezero"]["train"]["reanalyze"]),
        launches_rezero_plain_reanalyze=history["rezero"]["train"]["plain_reanalyze"]["launches"],
        launches_muzero_context=history["muzero_context"]["eval"]["launches"],
        launches_muzero_context_train=history["muzero_context"]["train"]["launches"],
        launches_muzero_rnn=history["muzero_rnn"]["eval"]["launches"],
        launches_muzero_rnn_train=history["muzero_rnn"]["train"]["launches"],
        # phase 12: the grids' conv MuZero and conv EfficientZero evals and
        # training runs, A = 3 and 4 on the small-A route
        **{f"launches_{name}{suffix}": grid[name][part]["launches"]
           for name in ("breakout_muzero", "space_invaders_efficientzero")
           for suffix, part in (("", "eval"), ("_train", "train"))},
        # phase 13: Catch MuZero's and Memory EfficientZero's evals and
        # training runs (small-A route); TicTacToe AlphaZero (search, collect,
        # bot eval, training) and Connect4 MuZero's eval and training, whose
        # searches take the generic descent: 0
        **{f"launches_{name}{suffix}": probes[name][part]["launches"]
           for name in ("catch_muzero", "memory_efficientzero")
           for suffix, part in (("", "eval"), ("_train", "train"))},
        launches_tictactoe_alphazero=az["launches"],
        launches_connect4_muzero=c4["eval"]["launches"],
        launches_connect4_muzero_train=c4["train"]["launches"],
        # phase 14: Go 6x6, Gomoku (Gumbel and Sampled AlphaZero, MuZero) and
        # Chess AlphaZero, whose searches take the generic or the Gumbel
        # descent: 0
        **{f"launches_{name}": rec["launches"] for name, rec in big.items()},
        # phase 15: UniZero's (Grid Breakout, A=3, prefetch route) and Sampled
        # UniZero's (Pendulum, K=16, row read) evals and training runs
        **{f"launches_{name}{suffix}": uz[name][part]["launches"]
           for name in ("unizero", "sampled_unizero")
           for suffix, part in (("", "eval"), ("_train", "train"))},
        # phase 16: the multitask runs (evals and collect rounds of every
        # task view): ScaleZero v3 (K=20, row read), the CartPole + Pendulum
        # balance UniZero and the two-task muzero_multitask (A=2, prefetch)
        **{f"launches_mt_{name}": mt[name]["launches"]
           for name in ("scalezero_v3", "balance", "muzero_multitask")},
        # phase 17: the host collector and evaluator over the stand-in
        # (CartPole MuZero, A=2, prefetch route) and over the gymnasium
        # configs where their libraries import, the RND run on the memory env
        # (A=4) and eval_offline over its checkpoint; HarmonyDream's learn
        # steps search nothing
        launches_host_standin=host["standin"]["launches"],
        **{f"launches_host_{name}": rec["launches"]
           for name, rec in host["gymnasium"].items() if rec["ran"]},
        launches_rnd_memory=host["rnd"]["launches"],
        launches_eval_offline=host["eval_offline"]["launches"],
        # phase 18: the Agent's training run and its deploy (CartPole MuZero,
        # A=2, prefetch route); the LPIPS learn steps and the landscape
        # search nothing
        launches_agent_train=rest["agent"]["train_launches"],
        launches_agent_deploy=rest["agent"]["deploy_launches"],
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=main_case["ms"],
        # launch to launch through the wrapper, the host's dispatch included:
        # what a launch costs the main path at this shape
        wrapper_ms=main_case["wrapper_ms"],
        plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"],
        bound_by=main_case["bound_by"],
        library_ms=None,
        shape=dict(B=3, A=2, N=26, tie_break="noise"),
    ), dict(
        name="fused_backup",
        route="cuda",
        source="lightzero_tpu_torch/csrc/fused_backup.cu",
        replaces=None,
        # the main path's eval (CartPole MuZero), once a simulation
        launches=main_rec["backup_launches"],
        # the evals of EfficientZero (phase 7), Gumbel MuZero (phase 8, the
        # prior_is_logits flag) and Stochastic MuZero (phase 9, is_chance)
        launches_efficientzero=ez["eval"]["backup_launches"],
        launches_gumbel_muzero=gmz["eval"]["backup_launches"],
        launches_stochastic_muzero=smz["eval"]["backup_launches"],
        ms=cell_backup["ms"],
        wrapper_ms=cell_backup["wrapper_ms"],
        plain_ms=cell_backup["plain_ms"],
        bound_ms=cell_backup["bound_ms"],
        bound_by=cell_backup["bound_by"],
        library_ms=None,
        shape=dict(B=2048, A=6, N=51, embedding=[6, 6, 64], simulation=25),
    ), dict(
        name="channel_norm",
        route="cuda",
        source="lightzero_tpu_torch/csrc/channel_norm.cu",
        replaces=None,
        # Connect4 MuZero's eval (phase 13), a forward a site a network
        # call, and one of its learn steps, with three a site where the
        # call's output is back-propagated; each equals sites x calls
        launches=c4["eval"]["norm_launches"],
        launches_connect4_muzero_learn_step=c4["train"]["norm_launches_learn"],
        max_gaps={k: max(c["gaps"][k] for c in norm_cases) for k in CHANNEL_NORM_TOL},
        ms=moe_norm["ms"],
        wrapper_ms=moe_norm["wrapper_ms"],
        plain_ms=moe_norm["plain_ms"],
        bound_ms=moe_norm["bound_ms"],
        bound_by="bytes",
        library_ms=moe_norm["library_ms"],
        backward_ms=moe_norm["backward_ms"],
        backward_bound_ms=moe_norm["backward_bound_ms"],
        plain_backward_ms=moe_norm["plain_backward_ms"],
        shape=dict(map=moe_norm["shape"], residual=False),
    )]
    emit(dict(phase="done", wall_s=time.perf_counter() - t_start,
              build_s=build["seconds"], bench_sims_per_s=bench["sims_per_s_kernel"],
              train_wall_s=train["wall_s"], learn_step_ms=train["learn_step_ms_median"],
              efficientzero_eval_s_per_env_step=ez["eval"]["wall_per_env_step_s"],
              efficientzero_learn_step_ms=ez["train"]["learn_step_ms_median"],
              gumbel_eval_s_per_env_step=gmz["eval"]["wall_per_env_step_s"],
              gumbel_learn_step_ms=gmz["train"]["learn_step_ms_median"],
              stochastic_eval_s_per_env_step=smz["eval"]["wall_per_env_step_s"],
              stochastic_learn_step_ms=smz["train"]["learn_step_ms_median"],
              sampled_muzero_eval_s_per_env_step=sampled["sampled_muzero"]["eval"][
                  "wall_per_env_step_s"],
              sampled_muzero_learn_step_ms=sampled["sampled_muzero"]["train"][
                  "learn_step_ms_median"],
              sampled_efficientzero_eval_s_per_env_step=sampled["sampled_efficientzero"]["eval"][
                  "wall_per_env_step_s"],
              sampled_efficientzero_learn_step_ms=sampled["sampled_efficientzero"]["train"][
                  "learn_step_ms_median"],
              rezero_history_wall_s=history_wall,
              **{f"{name}_eval_s_per_env_step": rec["eval"]["wall_per_env_step_s"]
                 for name, rec in history.items()},
              **{f"{name}_learn_step_ms": rec["train"]["learn_step_ms_median"]
                 for name, rec in history.items()},
              grid_wall_s=grid_wall,
              **{f"{name}_eval_s_per_env_step": grid[name]["eval"]["wall_per_env_step_s"]
                 for name in ("breakout_muzero", "space_invaders_efficientzero")},
              **{f"{name}_learn_step_ms": grid[name]["train"]["learn_step_ms_median"]
                 for name in ("breakout_muzero", "space_invaders_efficientzero")},
              atari_width_initial_inference_ms=grid["atari_width"]["initial_inference_ms"],
              probes_wall_s=probes_wall,
              **{f"{name}_eval_s_per_env_step": probes[name]["eval"]["wall_per_env_step_s"]
                 for name in ("catch_muzero", "memory_efficientzero")},
              **{f"{name}_learn_step_ms": probes[name]["train"]["learn_step_ms_median"]
                 for name in ("catch_muzero", "memory_efficientzero")},
              **{f"{name}_collect_steps_per_s": probes[name]["train"]["collect_steps_per_s"]
                 for name in ("catch_muzero", "memory_efficientzero")},
              alphazero_wall_s=az_wall,
              tictactoe_alphazero_eval_s_per_env_step=az["eval"]["wall_per_env_step_s"],
              tictactoe_alphazero_learn_step_ms=az["train"]["learn_step_ms_median"],
              tictactoe_alphazero_collect_steps_per_s=az["collect"]["steps_per_s"],
              connect4_wall_s=c4_wall,
              connect4_muzero_eval_s_per_env_step=c4["eval"]["wall_per_env_step_s"],
              connect4_muzero_descent_ms_per_call=c4["eval"]["descent_ms_per_call"],
              connect4_muzero_learn_step_ms=c4["train"]["learn_step_ms_median"],
              connect4_muzero_collect_steps_per_s=c4["train"]["collect_steps_per_s"],
              big_boards_wall_s=big_wall,
              **{f"{name}_eval_s_per_env_step": rec["eval"]["wall_per_env_step_s"]
                 for name, rec in big.items()},
              **{f"{name}_learn_step_ms": rec["train"]["learn_step_ms_median"]
                 for name, rec in big.items() if "train" in rec},
              unizero_wall_s=uz_wall,
              **{f"{name}_{key}": uz[name][part][field]
                 for name in ("unizero", "sampled_unizero")
                 for key, part, field in (
                     ("eval_s_per_env_step", "eval", "wall_per_env_step_s"),
                     ("learn_step_ms", "train", "learn_step_ms_median"),
                     ("collect_steps_per_s", "train", "collect_steps_per_s"),
                     ("cache_bytes_per_node", "eval", "cache_bytes_per_node"))},
              multitask_wall_s=mt_wall,
              scalezero_eval_s_per_env_step=mt["scalezero_v3"]["eval_s_per_env_step"],
              scalezero_learn_step_ms=float(np.median(mt["learn"]["default_ms"])),
              scalezero_cagrad_learn_step_ms=float(np.median(mt["learn"]["cagrad_ms"])),
              host_wall_s=host_wall,
              host_standin_eval_s_per_env_step=host["standin"]["host_eval_s_per_env_step"],
              rnd_learn_step_ms=host["rnd"]["learn_step_ms_median"],
              harmony_learn_step_ms=host["harmony"]["learn_step_ms_median"],
              rest_of_item_20_wall_s=rest_wall,
              lpips_learn_step_ms=rest["lpips"]["learn_step_ms_median_with_lpips"],
              unizero_ws_learn_step_ms_without_lpips=rest["lpips"][
                  "learn_step_ms_median_without_lpips"],
              landscape_ms_per_point=rest["landscape"]["ms_per_point_card"],
              agent_train_wall_s=rest["agent"]["train_wall_s"],
              agent_deploy_wall_s=rest["agent"]["deploy_wall_s"]))
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
