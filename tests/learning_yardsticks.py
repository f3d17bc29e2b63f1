"""Train the port from scratch on the runs whose committed JAX logs give a
learning yardstick, with each run's own ``total_config.json`` (not a test: a
script, run by hand, on the card by default).

    python tests/learning_yardsticks.py [--runs catch deep_sea tictactoe_az gomoku6_az]
        [--device cpu]
        [--env-steps N] [--seeds 0 1] [--package jax]

Each run trains until the env steps at which the JAX run's ``log/train.txt``
first reached its mark, that eval included (or until its ``stop_value``),
evaluating as its config says: Catch MuZero (eval mean 1.0 at 10,240 env steps), DeepSea MuZero
(1.0 at 7,168), TicTacToe AlphaZero with augmentation (win rate 1.00
against the bot at 3,840), Gomoku 6x6 AlphaZero with augmentation (100
simulations, 64 channels; win rate 1.00 against the bot at 3,200). Prints one JSON line per run with its evals
(env steps, mean return, and for AlphaZero the win rate), the JAX mark, the
wall time and the card. ``--env-steps`` sets every run's budget instead
(a quick look on the CPU, or a longer run). ``--package jax`` trains the
JAX package's entries instead, on the CPU (``JAX_PLATFORMS=cpu``), for
the same runs and seeds: their spread across seeds is the yardstick's.
"""
import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
RUNS = {
    "catch": ("data_bsuite/catch_muzero_seed0", "muzero", 10_240, 1.0),
    "deep_sea": ("data_bsuite/deep_sea10_muzero_seed0", "muzero", 7_168, 1.0),
    "tictactoe_az": ("data_az/tictactoe_az_aug_cpu_seed0", "alphazero", 3_840, 1.0),
    "gomoku6_az": ("data_az/gomoku6_alphazero_seed0", "alphazero", 3_200, 1.0),
}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=10, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no GPU"


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", nargs="+", default=list(RUNS), choices=list(RUNS))
    parser.add_argument("--device", default=None)
    parser.add_argument("--env-steps", type=int, default=None)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--package", choices=("port", "jax"), default="port")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.package == "jax":
        from lightzero_tpu.config import Config
        from lightzero_tpu.entry.train_alphazero import train_alphazero
        from lightzero_tpu.entry.train_muzero import train_muzero
        device = {}
    else:
        from lightzero_tpu_torch.config import Config
        from lightzero_tpu_torch.entry import train_alphazero, train_muzero
        device = dict(device=args.device)

    for name, seed in ((n, s) for n in args.runs for s in args.seeds):
        run, kind, env_steps, mark = RUNS[name]
        cfg = json.loads((ROOT / run / "total_config.json").read_text())
        cfg["policy"]["model"]["observation_shape"] = (
            tuple(cfg["policy"]["model"]["observation_shape"])
            if isinstance(cfg["policy"]["model"]["observation_shape"], list)
            else cfg["policy"]["model"]["observation_shape"])
        with tempfile.TemporaryDirectory() as tmp:
            cfg["exp_name"] = os.path.join(tmp, name)
            t0 = time.time()
            train = train_alphazero if kind == "alphazero" else train_muzero
            # one step past the mark, so that the loop runs the eval at it
            _, state, stats = train(Config(cfg), seed=seed,
                                    max_env_step=args.env_steps or env_steps + 1, **device)
            wall = time.time() - t0
            with open(os.path.join(cfg["exp_name"], "log", "train.txt")) as f:
                text = f.read()
        evals = [dict(env_steps=int(m.group(1)), mean_return=float(m.group(2)),
                      **({"win_rate": float(m.group(3))} if m.group(3) else {}))
                 for m in re.finditer(r"envstep=(\d+) EVAL (?:mean_)?return=(-?[\d.]+)"
                                      r"(?: win=([\d.]+))?", text)]
        print(json.dumps(dict(run=name, seed=seed, package=args.package, config=run, jax_mark=mark, jax_env_steps=env_steps,
                              env_steps=stats["env_steps"], train_iter=stats["train_iter"],
                              best_return=float(stats["best_return"]), evals=evals, wall_s=wall,
                              card=card() if args.package == "port" else "cpu")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
