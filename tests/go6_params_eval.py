"""Play the committed Go 6x6 AlphaZero params against the rule bot through
both packages' ``eval_alphazero`` on the CPU (not a test: a script, run by
hand).

    JAX_PLATFORMS=cpu python tests/go6_params_eval.py [--episodes 24] [--seed 0]

The JAX package loads ``data_az/go6_alphazero_resume_seed0/ckpt/params_best``
itself (orbax); the port gets the same params through
``utils/params_import.py`` (the AlphaZero map at 64 channels, 2 res blocks
and 37 actions), saved as a port params export in a temporary directory.
Both run the run's own ``total_config.json`` (60 simulations, deterministic
play as player 1 against the capture-aware rule bot, komi 4.5) until
``--episodes`` games have ended. The two bots draw their tie-breaks from
different random streams, so the means are compared within their spread,
not game for game; the run's own ``eval_verdict.json`` (win rate 0.958 over
24 games) is printed beside them. Prints one JSON line per package and one
with both win rates, the difference of the means and its standard error.
"""
import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
RUN = ROOT / "data_az" / "go6_alphazero_resume_seed0"


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--episodes", type=int, default=24)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))

    import jax
    import numpy as np
    import torch

    from lightzero_tpu.config import Config as JaxConfig
    from lightzero_tpu.entry.train_alphazero import eval_alphazero as jax_eval_alphazero
    from lightzero_tpu.utils.checkpoint import load_checkpoint
    from lightzero_tpu_torch.config import Config
    from lightzero_tpu_torch.entry import eval_alphazero
    from lightzero_tpu_torch.envs import GoEnv
    from lightzero_tpu_torch.policy import AlphaZeroPolicy
    from lightzero_tpu_torch.utils.checkpoint import save_params_export
    from lightzero_tpu_torch.utils.params_import import flax_to_state_dict

    total = json.loads((RUN / "total_config.json").read_text())
    total["policy"]["model"]["observation_shape"] = tuple(total["policy"]["model"]["observation_shape"])
    ckpt = str(RUN / "ckpt" / "params_best")
    total["exp_name"] = os.path.join(tempfile.gettempdir(), "go6_params_eval")
    results = {}

    t0 = time.time()
    jax_res = jax_eval_alphazero(JaxConfig(total), seed=args.seed, model_path=ckpt,
                                 n_episodes=args.episodes)
    results["jax"] = dict(returns=[float(r) for r in jax_res["episode_returns"]],
                          seconds=time.time() - t0)

    restored = load_checkpoint(ckpt)
    params = jax.tree_util.tree_map(np.asarray, restored["params"])
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(total)
        policy = AlphaZeroPolicy(cfg.policy, GoEnv(**cfg.env.env_kwargs), device="cpu",
                                 seed=args.seed)
        state = policy.init_train_state()
        state.model.load_state_dict(flax_to_state_dict(params))
        export = save_params_export(state, os.path.join(tmp, "params_best"))
        t0 = time.time()
        with torch.no_grad():
            res = eval_alphazero(cfg, seed=args.seed, model_path=export,
                                 n_episodes=args.episodes, device="cpu")
        results["port"] = dict(returns=res["episode_returns"], seconds=time.time() - t0)
    for name, r in results.items():
        r.update(package=name, episodes=len(r["returns"]), mean=float(np.mean(r["returns"])),
                 std=float(np.std(r["returns"])),
                 win_rate=float(np.mean([x > 0 for x in r["returns"]])),
                 wins=int(sum(x > 0 for x in r["returns"])),
                 losses=int(sum(x < 0 for x in r["returns"])))
        print(json.dumps(r), flush=True)
    verdict = json.loads((RUN / "eval_verdict.json").read_text())
    print(json.dumps(dict(jax_win_rate=results["jax"]["win_rate"],
                          port_win_rate=results["port"]["win_rate"],
                          jax_mean=results["jax"]["mean"], port_mean=results["port"]["mean"],
                          difference=results["port"]["mean"] - results["jax"]["mean"],
                          stderr_of_difference=float(np.sqrt(
                              results["jax"]["std"] ** 2 / results["jax"]["episodes"]
                              + results["port"]["std"] ** 2 / results["port"]["episodes"])),
                          verdict_win_rate=verdict["win_rate"],
                          verdict_mean=verdict["mean_return"],
                          verdict_games=verdict["n_episodes"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
