"""Two-process dry run of the scale-out path on the CPU (gloo), each phase
held against one process doing the same work unsharded (the role of
``lightzero_tpu/parallel/dryrun.py`` and ``dryrun_multiproc.py``):

  1. a MuZero ``ddp_learn_step``: the loss, the synchronised gradients, the
     new params and the priorities equal one process's learn step on the
     whole batch, and both ranks hold the same params;
  2. a collect search and a reanalyze with the roots sharded over the ranks:
     the gathered visit counts equal the unsharded search's, the values
     within 1e-6;
  3. a UniZero ``ddp_learn_step`` with Encoder-Clip on, whose threshold
     acts: the shards' latent-norm maxima differ, the MAX-reduced one gives
     the single process's clip and step; then a step whose NaN lies in one
     rank's shard, which every rank skips, as the single process does;
  4. the multitask partition: the tasks' rows in contiguous blocks, their
     weights folded into the importance weights, one ``ddp_learn_step``
     against one process; ``partition_tasks`` over 5 tasks; and the
     multitask entry at world size 2, which trains each rank's tasks
     without a gradient sync (as the JAX entry does): the ranks' params
     part;
  5. the control plane: ``init_distributed`` with the rank and the world,
     the collector-stat mean, rank 0's eval record and task weights
     broadcast, the task returns all-gathered.

Run it with ``python -m lightzero_tpu_torch.parallel.dryrun`` (``launch``
starts the two ranks, which rendezvous through a ``file://`` store in a
temporary directory, so that concurrent runs cannot collide on a port).
"""
from __future__ import annotations

import copy
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

OK_MARK = "DRYRUN_RANK_OK"
PARAM_ATOL = 1e-6


def _close(a, b, rtol, atol, what):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    if not torch.allclose(a, b, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max |diff| {float((a - b).abs().max())}")


# the policies of the learn-step phases (the JAX package's defaults beneath)
MUZERO_CONFIG = dict(model=dict(observation_shape=4, action_space_size=2, latent_state_dim=32,
                                support_scale=25, self_supervised_learning_loss=True,
                                proj_hid=64, proj_out=64, pred_hid=32, pred_out=64),
                     ssl_loss_weight=2.0, num_simulations=6, batch_size=16)
UNIZERO_CONFIG = dict(model=dict(observation_shape=4, action_space_size=2, embed_dim=32,
                                 num_layers=1, num_heads=2, max_tokens=12, support_scale=5),
                      num_unroll_steps=4, num_simulations=5, learning_rate=1e-3,
                      use_encoder_clip_annealing=True, encoder_clip_start=0.3,
                      encoder_clip_end=0.3)


def _muzero_policy(**over):
    from lightzero_tpu_torch.config import deep_merge
    from lightzero_tpu_torch.policy import MuZeroPolicy

    return MuZeroPolicy(deep_merge(MUZERO_CONFIG, over), device="cpu", seed=0)


def random_batch(B: int, K: int, A: int, seed: int, task_rows=None, task_weights=None):
    """A numpy-seeded CartPole-shaped ``TrainBatch`` (observations 4, A
    actions, K unroll steps); with ``task_rows``, each row's target values
    its task id and its importance weight its task's weight."""
    from lightzero_tpu_torch.policy.muzero import TrainBatch

    rng = np.random.default_rng(seed)
    tv = rng.uniform(-10, 10, (B, K + 1))
    w = rng.uniform(0.3, 1.0, B)
    if task_rows is not None:
        tv = task_rows[:, None] * np.ones((B, K + 1))
        w = task_weights[task_rows]
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    return TrainBatch(obs=f32(rng.standard_normal((B, K + 1, 4))),
                      actions=torch.from_numpy(rng.integers(0, A, (B, K))),
                      mask=f32(rng.random((B, K)) < 0.8),
                      target_reward=f32(rng.uniform(-1, 1, (B, K))), target_value=f32(tv),
                      target_policy=f32(rng.dirichlet(np.ones(A), (B, K + 1))), weights=f32(w))


def _same_on_every_rank(t: torch.Tensor, what: str) -> None:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    if not all(torch.equal(p, parts[0]) for p in parts):
        raise AssertionError(f"{what} differs between the ranks")


def _flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _check_step(ctx, name, ref_policy, ref_state, policy, state, batch):
    """One learn step on the whole batch in this process and one
    ddp_learn_step, checked against each other; with ``ctx["records"]``
    the step's inputs and results are kept under ``name``."""
    from lightzero_tpu_torch.parallel.ddp import ddp_learn_step

    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    ref_state, ref_logs, ref_prio = ref_policy.forward_learn(ref_state, batch)
    state, logs, prio = ddp_learn_step(policy, state, batch)
    if "records" in ctx:
        ctx["records"][name] = dict(
            init=init, batch=batch._asdict(),
            params={k: v.clone() for k, v in state.model.state_dict().items()},
            grads={n: p.grad.clone() for n, p in state.model.named_parameters()},
            logs={k: float(v) for k, v in logs.items()}, priority=prio)
    _close(logs["total_loss"], ref_logs["total_loss"], 1e-5, 1e-7, "loss")
    _close(prio, ref_prio, 1e-5, 1e-6, "priorities")
    scale = max(float(p.grad.abs().max()) for p in ref_state.model.parameters())
    lr = float(policy.cfg.learning_rate)
    for (name, p), q in zip(ref_state.model.named_parameters(), state.model.parameters()):
        _close(q.grad, p.grad, 1e-4, 1e-6 * scale, f"gradient {name}")
        # Adam's first step is about lr * sign(g): where g is at the
        # summation order's rounding, the sign may differ
        tight = p.grad.abs() > 1e-6 * scale
        _close(q.detach()[tight], p.detach()[tight], 0, PARAM_ATOL, f"param {name}")
        _close(q.detach(), p.detach(), 0, 2 * lr, f"param {name}")
    _same_on_every_rank(_flat_params(state.model), "the params")
    return ref_state, ref_logs, state, logs


def phase_muzero_step(ctx) -> str:
    policy = _muzero_policy()
    ref = _muzero_policy()
    batch = random_batch(16, 5, 2, seed=1)
    _, ref_logs, _, _ = _check_step(ctx, "muzero", ref, ref.init_train_state(), policy,
                                    policy.init_train_state(), batch)
    return f"muzero_ddp_step loss={float(ref_logs['total_loss']):.4f}==single"


def phase_sharded_search(ctx) -> str:
    import dataclasses

    from lightzero_tpu_torch.parallel.ddp import shard

    policy = _muzero_policy(model=dict(action_space_size=3, latent_state_dim=16,
                                       self_supervised_learning_loss=False),
                            num_simulations=6, reanalyze_noise=False)
    policy.search_cfg = dataclasses.replace(policy.search_cfg, tie_break="first")
    world, rank = dist.get_world_size(), dist.get_rank()
    B = 8
    obs = torch.linspace(-1, 1, B * 4).reshape(B, 4)
    legal = torch.ones((B, 3), dtype=torch.bool)
    to_play = torch.full((B,), -1, dtype=torch.int32)
    ref = policy._forward_collect(obs, legal, to_play, 1.0, 0.0, deterministic=True)
    ref_re = policy.forward_reanalyze(policy.model, obs, legal)
    local = policy._forward_collect(*shard((obs, legal, to_play), rank, world), 1.0, 0.0,
                                    deterministic=True)
    local_re = policy.forward_reanalyze(policy.model, *shard((obs, legal), rank, world))

    def gathered(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    if not torch.equal(gathered(local["visit_counts"]), ref["visit_counts"]):
        raise AssertionError("sharded search visit counts differ from the unsharded search")
    _close(gathered(local["searched_value"]), ref["searched_value"], 1e-5, 1e-6, "root values")
    if not torch.equal(gathered(local_re[0]), ref_re[0]):
        raise AssertionError("sharded reanalyze targets differ from the unsharded reanalyze")
    _close(gathered(local_re[1]), ref_re[1], 1e-5, 1e-6, "reanalyze root values")
    return "sharded_search+reanalyze == unsharded"


def _unizero_policy():
    from lightzero_tpu_torch.policy import UniZeroPolicy

    return UniZeroPolicy(UNIZERO_CONFIG, device="cpu", seed=0)


def phase_unizero_step(ctx) -> str:
    from lightzero_tpu_torch.parallel.ddp import shard

    world, rank = dist.get_world_size(), dist.get_rank()
    policy, ref = _unizero_policy(), _unizero_policy()
    batch = random_batch(8, 4, 2, seed=3)
    # the shards' own maxima differ, so the clip needs the MAX reduction
    _, _, local_logs, _ = policy._sample_losses(policy.model, shard(batch, rank, world))
    parts = [torch.empty(1) for _ in range(world)]
    dist.all_gather(parts, local_logs["latent_norm_max"].reshape(1))
    if len(set(float(p) for p in parts)) < 2:
        raise AssertionError("the shards' latent norm maxima are equal: the check is void")
    ref_state, ref_logs, state, logs = _check_step(ctx, "unizero", ref, ref.init_train_state(),
                                                   policy, policy.init_train_state(), batch)
    if not float(ref_logs["encoder_clip_scale"]) < 1.0:
        raise AssertionError("Encoder-Clip did not act")
    _close(logs["encoder_clip_scale"], ref_logs["encoder_clip_scale"], 1e-6, 0, "clip scale")
    summary = (f"unizero_ddp_step loss={float(ref_logs['total_loss']):.4f} clip="
               f"{float(logs['encoder_clip_scale']):.3f}==single, nan step skipped")
    # a NaN in rank 1's shard: every rank skips the step, as one process does
    nan_obs = batch.obs.clone()
    nan_obs[-1, 1, 0] = float("nan")
    nan_batch = batch._replace(obs=nan_obs)
    before = _flat_params(state.model).clone()
    from lightzero_tpu_torch.parallel.ddp import ddp_learn_step

    ref_state, ref_logs, _ = ref.forward_learn(ref_state, nan_batch)
    state, logs, _ = ddp_learn_step(policy, state, nan_batch)
    if not float(logs["nonfinite_loss"]) == float(ref_logs["nonfinite_loss"]) == 1.0:
        raise AssertionError("the non-finite step was not skipped on every rank")
    if not torch.equal(_flat_params(state.model), before):
        raise AssertionError("a skipped step moved the params")
    _same_on_every_rank(_flat_params(state.model), "the params after the skipped step")
    return summary


def phase_multitask_partition(ctx) -> str:
    from lightzero_tpu_torch.configs.cartpole_muzero import main_config
    from lightzero_tpu_torch.entry import train_muzero_multitask
    from lightzero_tpu_torch.parallel.distributed import partition_tasks

    rank = dist.get_rank()
    num_tasks, B = 2, 16
    rows = np.repeat(np.arange(num_tasks), B // num_tasks)
    batch = random_batch(B, 5, 2, seed=4, task_rows=rows, task_weights=np.array([1.5, 0.5]))
    policy, ref = _muzero_policy(), _muzero_policy()
    _check_step(ctx, "multitask_partition", ref, ref.init_train_state(), policy,
                policy.init_train_state(), batch)
    parts = [partition_tasks(5, rank=r, world_size=2) for r in range(2)]
    if parts != [[0, 1, 2], [3, 4]] or partition_tasks(5) != parts[rank]:
        raise AssertionError(f"partition_tasks: {parts}")
    # the multitask entry: each rank trains the policy on its own tasks
    cfgs = []
    for _ in range(num_tasks):
        c = copy.deepcopy(main_config)
        c.exp_name = os.path.join(ctx["tmp"], f"entry_rank{rank}")
        c.env.update(collector_env_num=2, evaluator_env_num=2, max_episode_steps=16)
        c.policy.type = "muzero_multitask"
        c.policy.model.latent_state_dim = 16
        c.policy.update(num_simulations=3, batch_size=16, update_per_collect=2, n_episode=2)
        cfgs.append(c)
    _, state, stats = train_muzero_multitask(cfgs, max_train_iter=2, device="cpu")
    if sorted(stats["task_env_steps"]) != [rank]:
        raise AssertionError(f"rank {rank} collected tasks {sorted(stats['task_env_steps'])}")
    flat = _flat_params(state.model)
    others = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(others, flat)
    if torch.equal(others[0], others[1]):
        raise AssertionError("the entry's ranks hold equal params: expected no gradient sync")
    return "multitask_partition == single; entry ranks train apart (no gradient sync)"


def phase_control_plane(ctx) -> str:
    from lightzero_tpu_torch.entry.train_muzero_multitask import compute_task_weights
    from lightzero_tpu_torch.parallel.distributed import (
        all_gather_scalars,
        allreduce_mean_scalars,
        barrier,
        broadcast_from_main,
        get_rank,
        is_main_process,
    )

    rank = get_rank()
    barrier()
    stats = allreduce_mean_scalars({"collect_return": 10.0 * (rank + 1),
                                    "env_steps": 100.0 * (rank + 1)})
    if stats != {"collect_return": 15.0, "env_steps": 150.0}:
        raise AssertionError(f"allreduce_mean_scalars: {stats}")
    got = broadcast_from_main(np.asarray([1.0 if rank == 0 else -1.0, 42.5 + rank], np.float32))
    if got.tolist() != [1.0, 42.5]:
        raise AssertionError(f"broadcast_from_main: {got}")
    returns = all_gather_scalars({"task_return": float(rank + 1)})["task_return"]
    if returns.tolist() != [1.0, 2.0]:
        raise AssertionError(f"all_gather_scalars: {returns}")
    weights = np.zeros(2, np.float64)
    if is_main_process():
        w = compute_task_weights({0: returns[0], 1: returns[1]}, {0: 10.0, 1: 10.0})
        weights = np.asarray([w[0], w[1]])
    weights = broadcast_from_main(weights)
    if not (weights[0] > weights[1] > 0 and abs(weights.mean() - 1.0) < 1e-12):
        raise AssertionError(f"task weights {weights}")
    return "control_plane: mean+broadcast+gather+task_weights"


PHASES = (phase_muzero_step, phase_sharded_search, phase_unizero_step,
          phase_multitask_partition, phase_control_plane)


def worker(rank: int, world_size: int, init_method: str, out_dir: str = "") -> None:
    """One rank: start the gloo group, run every phase, print the mark. With
    ``out_dir``, rank 0 saves the learn-step phases' inputs and results to
    ``out_dir/dryrun_records.pt``."""
    from lightzero_tpu_torch.parallel.distributed import init_distributed

    torch.set_num_threads(1)
    info = init_distributed(init_method=init_method, world_size=world_size, rank=rank,
                            backend="gloo")
    if info != dict(rank=rank, world_size=world_size):
        raise AssertionError(f"init_distributed: {info}")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ctx = dict(tmp=tmp)
            if out_dir and rank == 0:
                ctx["records"] = {}
            for phase in PHASES:
                t0 = time.perf_counter()
                summary = phase(ctx)
                print(f"rank {rank}: {summary} [{time.perf_counter() - t0:.1f} s]", flush=True)
            if "records" in ctx:
                torch.save(ctx["records"], os.path.join(out_dir, "dryrun_records.pt"))
        print(f"{OK_MARK} rank={rank}/{world_size}", flush=True)
    finally:
        dist.destroy_process_group()


def launch(world_size: int = 2, timeout: float = 300.0, out_dir: str = "") -> str:
    """Start ``world_size`` ranks, wait, and check that each printed its
    mark; returns rank 0's phase lines. The ranks are killed at the
    timeout. ``out_dir``: see ``worker``."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "lightzero_tpu_torch.parallel.dryrun", str(r),
             str(world_size), init_method, os.path.abspath(out_dir) if out_dir else ""],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=tmp, env=env)
            for r in range(world_size)]
        deadline = time.monotonic() + timeout
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                outs.append(out)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"the dry run passed its {timeout} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or OK_MARK not in out:
            raise RuntimeError(f"rank {r} failed (rc={p.returncode}):\n{out[-4000:]}")
    return "\n".join(line for line in outs[0].splitlines() if line.startswith("rank 0:"))


if __name__ == "__main__":
    if len(sys.argv) == 5:
        worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        print(launch())
