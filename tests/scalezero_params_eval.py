"""Play the committed ScaleZero v3 params (Sampled UniZero multitask over 3
Pendulum tasks) through both packages on the CPU, task by task (not a test:
a script, run by hand).

    JAX_PLATFORMS=cpu python tests/scalezero_params_eval.py [--episodes 8] [--envs 8] [--seed 11]

The JAX package loads ``data_mt/pendulum_suite_scalezero_v3_seed0/ckpt/params_best``
itself (orbax), builds the run's policy from its ``total_config.json`` and
evaluates each task's view as ``scripts/eval_scalezero_best.py`` does; the
port gets the same params through ``utils/params_import.py`` and evaluates
its own task views with its ``Evaluator``. Each package plays every task on
``--envs`` envs until ``--episodes`` episodes have ended (25 simulations,
K=20, deterministic play, each step searched from its episode's KV-cache
context). The envs' resets draw from different random streams, so the
means are compared within their spread, not episode for episode. Prints one
JSON line per package and task, and one per task with both means, their
difference and its standard error, beside the run's ``eval_verdict.json``
(12 episodes on 2 envs).
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
RUN = ROOT / "data_mt" / "pendulum_suite_scalezero_v3_seed0"


def stats(returns):
    import numpy as np

    r = np.asarray(returns, np.float64)
    return dict(episodes=len(r), mean=float(r.mean()), std=float(r.std()),
                stderr=float(r.std(ddof=1) / np.sqrt(len(r))))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--episodes", type=int, default=8)
    parser.add_argument("--envs", type=int, default=8)
    parser.add_argument("--seed", type=int, default=11)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))

    import jax
    import numpy as np
    import torch

    from lightzero_tpu.config import Config as JaxConfig
    from lightzero_tpu.entry.train_muzero import create_env as jax_create_env
    from lightzero_tpu.policy.multitask import SampledUniZeroMTPolicy as JaxPolicy
    from lightzero_tpu.utils.checkpoint import load_checkpoint
    from lightzero_tpu.workers import Evaluator as JaxEvaluator
    from lightzero_tpu_torch.config import Config
    from lightzero_tpu_torch.configs.pendulum_suite_scalezero_v3 import task_configs
    from lightzero_tpu_torch.entry.train_muzero import create_env
    from lightzero_tpu_torch.policy import SampledUniZeroMTPolicy
    from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
    from lightzero_tpu_torch.workers import Evaluator

    total = json.loads((RUN / "total_config.json").read_text())
    params = load_checkpoint(str(RUN / "ckpt" / "params_best"))["params"]
    jax_policy = JaxPolicy(JaxConfig(total["policy"]))
    port = SampledUniZeroMTPolicy(Config(total["policy"]), device="cpu", seed=args.seed)
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    verdict = json.loads((RUN / "eval_verdict.json").read_text())["tasks"]
    rng = jax.random.PRNGKey(args.seed)
    for task, c in enumerate(task_configs):
        results = {}
        t0 = time.time()
        rng, e_rng = jax.random.split(rng)
        env = jax_create_env(JaxConfig(c.to_dict()).env)
        res = JaxEvaluator(env, jax_policy.task_view(task), args.envs, rng=e_rng).eval(
            params, n_episodes=args.episodes)
        results["jax"] = dict(returns=[float(r) for r in res["episode_returns"]],
                              seconds=time.time() - t0)
        t0 = time.time()
        with torch.no_grad():
            res = Evaluator(create_env(c.env), port.task_view(task), args.envs,
                            seed=args.seed + task, device="cpu").eval(n_episodes=args.episodes)
        results["port"] = dict(returns=res["episode_returns"], seconds=time.time() - t0)
        for name, r in results.items():
            r.update(package=name, task=task, **stats(r["returns"]))
            print(json.dumps(r), flush=True)
        jax_r, port_r = results["jax"], results["port"]
        print(json.dumps(dict(
            task=task, jax_mean=jax_r["mean"], port_mean=port_r["mean"],
            difference=port_r["mean"] - jax_r["mean"],
            stderr_of_difference=float(np.hypot(jax_r["stderr"], port_r["stderr"])),
            verdict_mean=verdict[task]["mean_return"],
            verdict_episodes=len(verdict[task]["returns"]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
