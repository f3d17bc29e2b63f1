"""Play the committed Connect4 MuZero params against the rule bot through
both packages' ``eval_muzero`` on the CPU (not a test: a script, run by
hand).

    JAX_PLATFORMS=cpu python tests/connect4_params_eval.py [--episodes 24] [--seed 0]

The JAX package loads ``data_mz/connect4_muzero_ft_seed0/ckpt/params_best``
itself; the port gets the same params through ``utils/params_import.py``
(the conv importer, as it is), saved as a port params export in a temporary
directory. Both run the run's own ``total_config.json`` (conv 64 channels,
50 simulations, 5 eval envs against the rule bot, deterministic) until
``--episodes`` games have ended. The two bots draw their tie-breaks from
different random streams, so the means are compared within their spread,
not game for game; the run's own ``eval_verdict.json`` (0.736 over 53 games)
is printed beside them. Prints one JSON line per package and one with both
means and the difference.
"""
import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
RUN = ROOT / "data_mz" / "connect4_muzero_ft_seed0"


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
    from lightzero_tpu.entry import eval_muzero as jax_eval_muzero
    from lightzero_tpu.utils.checkpoint import load_checkpoint
    from lightzero_tpu_torch.config import Config
    from lightzero_tpu_torch.entry import eval_muzero
    from lightzero_tpu_torch.policy import MuZeroPolicy
    from lightzero_tpu_torch.utils.checkpoint import save_params_export
    from lightzero_tpu_torch.utils.params_import import flax_to_state_dict

    total = json.loads((RUN / "total_config.json").read_text())
    total["policy"]["model"]["observation_shape"] = tuple(total["policy"]["model"]["observation_shape"])
    ckpt = str(RUN / "ckpt" / "params_best")
    total["exp_name"] = os.path.join(tempfile.gettempdir(), "connect4_params_eval")
    results = {}

    t0 = time.time()
    jax_res = jax_eval_muzero(JaxConfig(total), seed=args.seed, model_path=ckpt,
                              n_episodes=args.episodes)
    results["jax"] = dict(returns=[float(r) for r in jax_res["episode_returns"]],
                          seconds=time.time() - t0)

    restored = load_checkpoint(ckpt)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(total)
        policy = MuZeroPolicy(cfg.policy, device="cpu", seed=args.seed)
        state = policy.init_train_state()
        for model, tree in ((state.model, "params"), (state.target_model, "target_params")):
            params = restored.get(tree, restored["params"])
            model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
        export = save_params_export(state, os.path.join(tmp, "params_best"))
        t0 = time.time()
        with torch.no_grad():
            res = eval_muzero(cfg, seed=args.seed, model_path=export, n_episodes=args.episodes,
                              device="cpu")
        results["port"] = dict(returns=res["episode_returns"], seconds=time.time() - t0)
    for name, r in results.items():
        r.update(package=name, episodes=len(r["returns"]), mean=float(np.mean(r["returns"])),
                 std=float(np.std(r["returns"])),
                 wins=int(sum(x > 0 for x in r["returns"])),
                 losses=int(sum(x < 0 for x in r["returns"])))
        print(json.dumps(r), flush=True)
    verdict = json.loads((RUN / "eval_verdict.json").read_text())["params_best"]
    print(json.dumps(dict(jax_mean=results["jax"]["mean"], port_mean=results["port"]["mean"],
                          difference=results["port"]["mean"] - results["jax"]["mean"],
                          stderr_of_difference=float(np.sqrt(
                              results["jax"]["std"] ** 2 / results["jax"]["episodes"]
                              + results["port"]["std"] ** 2 / results["port"]["episodes"])),
                          verdict_mean=verdict["mean"], verdict_games=verdict["n"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
