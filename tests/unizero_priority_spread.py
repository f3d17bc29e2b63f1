"""The spread of UniZero's learn-step priorities, card against CPU, at the
size of chip_smoke.py's phase 15 (not a test: a script for a CUDA machine).

    python3 tests/unizero_priority_spread.py [--seeds 3] [--batches 3]

For each seed, a train_muzero run of the Grid Breakout ws config at full
width as phase 15 runs it (episodes cut at UZ_TRAIN_EPISODE_STEPS, one
collect round, SHORT_TRAIN_ITERS learn steps); then, on each of
``--batches`` batches sampled from its buffer, one learn step on the card
and one on the CPU from the same params and a fresh optimizer, and their
priorities' largest error over the bound phase 15 holds them to
(``chip_smoke.priority_err_over_bound``: VALUE_TOL x the value plus one
float32 step of h^-1; 1 is the limit). On the first batch of each seed the
card's step is taken twice more: with TF32 on for its matmuls and
convolutions (the lower-precision control), and with the value head's last
layer scaled by 1 + 1e-3 (a planted fault). Prints one JSON line per
reading and, last, the largest sound reading and the smallest of each
other kind.
"""
import argparse
import copy
import json
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--batches", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("unizero_priority_spread: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from lightzero_tpu_torch.configs.breakout_grid_unizero_ws import main_config
    from lightzero_tpu_torch.entry import train_muzero

    def priorities(policy, batch, dev, planted=False):
        p = type(policy)(policy.cfg, model=copy.deepcopy(policy.model), device=dev)
        if planted:
            with torch.no_grad():
                p.model.value_head.dense[-1].weight.mul_(1.0 + 1e-3)
        _, _, priority = p.forward_learn(p.init_train_state(), cs.batch_to(batch, p.device))
        return priority.cpu()

    def set_tf32(on):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    set_tf32(False)
    readings = {"sound": [], "tf32": [], "planted": []}
    for seed in range(args.seeds):
        cfg = copy.deepcopy(main_config)
        cfg.env.max_steps = cs.UZ_TRAIN_EPISODE_STEPS
        cfg.policy.train_start_after_envsteps = 0
        cfg.policy.update_per_collect = cs.SHORT_TRAIN_ITERS
        with tempfile.TemporaryDirectory() as tmp:
            cfg.exp_name = os.path.join(tmp, "unizero")
            policy, state, stats = train_muzero(cfg, seed=seed, max_train_iter=cs.SHORT_TRAIN_ITERS)
        for b in range(args.batches):
            batch, _ = stats["buffer"].sample(int(policy.cfg.batch_size), state.target_model)
            cpu = priorities(policy, batch, "cpu")
            kinds = ("sound", "tf32", "planted") if b == 0 else ("sound",)
            for kind in kinds:
                set_tf32(kind == "tf32")
                try:
                    card = priorities(policy, batch, "cuda", planted=kind == "planted")
                finally:
                    set_tf32(False)
                ratio = cs.priority_err_over_bound(card, cpu, batch)
                readings[kind].append(ratio)
                cs.emit(dict(phase="priority_reading", seed=seed, batch=b, kind=kind,
                             priority_err_over_bound=ratio,
                             priority_max_abs_err=float((card - cpu).abs().max())))
    print(json.dumps(dict(phase="priority_spread", card=cs.phase_card(), readings=readings,
                          sound_max=max(readings["sound"]), tf32_min=min(readings["tf32"]),
                          planted_min=min(readings["planted"]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
