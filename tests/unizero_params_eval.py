"""Play the committed Grid Breakout UniZero params (the ws2 run) through both
packages' ``eval_unizero`` on the CPU (not a test: a script, run by hand).

    JAX_PLATFORMS=cpu python tests/unizero_params_eval.py [--episodes 16] [--seed 0]

The JAX package loads ``data_uz/breakout_grid_unizero_ws2_seed0/ckpt/params_best``
itself (orbax); the port gets the same params through
``utils/params_import.py`` (UniZero's map: conv 64, embed 256, 2 layers, 8
heads), saved as a port params export in a temporary directory. Both run the
run's own ``total_config.json`` (25 simulations, deterministic play, each
env step searched from its episode's KV-cache context) on 3 envs until
``--episodes`` episodes have ended. The envs' resets draw from different
random streams, so the means are compared within their spread, not episode
for episode; the run's ``eval_verdict.json`` (mean 14.19 over 16) is printed
beside them. Prints one JSON line per package and one with both means, the
difference and its standard error.
"""
import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
RUN = ROOT / "data_uz" / "breakout_grid_unizero_ws2_seed0"


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--episodes", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))

    import jax
    import numpy as np
    import torch

    from lightzero_tpu.config import Config as JaxConfig
    from lightzero_tpu.entry import eval_unizero as jax_eval_unizero
    from lightzero_tpu.utils.checkpoint import load_checkpoint
    from lightzero_tpu_torch.config import Config
    from lightzero_tpu_torch.entry import eval_unizero
    from lightzero_tpu_torch.policy import UniZeroPolicy
    from lightzero_tpu_torch.utils.checkpoint import save_params_export
    from lightzero_tpu_torch.utils.params_import import flax_to_state_dict

    total = json.loads((RUN / "total_config.json").read_text())
    total["policy"]["model"]["observation_shape"] = tuple(total["policy"]["model"]["observation_shape"])
    total["exp_name"] = os.path.join(tempfile.gettempdir(), "unizero_params_eval")
    ckpt = str(RUN / "ckpt" / "params_best")
    results = {}

    t0 = time.time()
    jax_res = jax_eval_unizero(JaxConfig(total), seed=args.seed, model_path=ckpt,
                               n_episodes=args.episodes)
    results["jax"] = dict(returns=[float(r) for r in jax_res["episode_returns"]],
                          seconds=time.time() - t0)

    restored = load_checkpoint(ckpt)
    params = jax.tree_util.tree_map(np.asarray, restored["params"])
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(total)
        policy = UniZeroPolicy(cfg.policy, device="cpu", seed=args.seed)
        state = policy.init_train_state()
        state.model.load_state_dict(flax_to_state_dict(params))
        export = save_params_export(state, os.path.join(tmp, "params_best"))
        t0 = time.time()
        with torch.no_grad():
            res = eval_unizero(cfg, seed=args.seed, model_path=export,
                               n_episodes=args.episodes, device="cpu")
        results["port"] = dict(returns=res["episode_returns"], seconds=time.time() - t0)
    for name, r in results.items():
        r.update(package=name, episodes=len(r["returns"]), mean=float(np.mean(r["returns"])),
                 std=float(np.std(r["returns"])))
        print(json.dumps(r), flush=True)
    verdict = json.loads((RUN / "eval_verdict.json").read_text())["params_best"]
    print(json.dumps(dict(jax_mean=results["jax"]["mean"], port_mean=results["port"]["mean"],
                          difference=results["port"]["mean"] - results["jax"]["mean"],
                          stderr_of_difference=float(np.sqrt(
                              results["jax"]["std"] ** 2 / results["jax"]["episodes"]
                              + results["port"]["std"] ** 2 / results["port"]["episodes"])),
                          verdict_mean=verdict["mean"], verdict_episodes=verdict["n"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
