"""Data-parallel learn step on ``torch.distributed`` (the role of
``lightzero_tpu/parallel/mesh.py``'s ``dp_train_step``, which shards the
batch over a device mesh and lets XLA insert the gradient reduction).

``ddp_learn_step`` runs the policy's own learn step on this rank's shard of
the global batch, with a gradient sync between backward and the clip: one
bucketed ``all_reduce`` averages every gradient and the logged means over
the ranks. Means of per-sample terms over equal shards average to the
global batch's, but the batch statistics that steer an update do not:
Encoder-Clip's ``latent_norm_max`` and Head-Clip's logit maxima are reduced
with MAX, and a non-finite loss or gradient on any rank makes the averages
non-finite everywhere, so that every rank's non-finite guard skips the same
step. Every rank then takes the same step, and the replicas stay equal.
The priorities come back for the whole batch, in its order.

Not covered, and refused: the multitask policies (their per-task means are
not means over equal shards) and micro-batch accumulation (a rank's micro-
batches are not the global batch's).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

# the logged batch maxima that steer Encoder-Clip and Head-Clip
MAX_LOGS = ("latent_norm_max", "policy_logits_max", "value_logits_max", "reward_logits_max")


class GradSync:
    """The policy's ``grad_sync`` for one step: averages the gradients and
    the logged 0-d means over the ranks in one all_reduce, and takes the
    maxima of ``MAX_LOGS`` in a second, small one."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = group
        self.world = dist.get_world_size(group)

    def __call__(self, params: List[torch.Tensor], logs: Dict[str, torch.Tensor]) -> None:
        grads = [p.grad for p in params]
        means = [k for k, v in logs.items()
                 if torch.is_tensor(v) and v.dim() == 0 and k not in MAX_LOGS]
        maxima = [k for k in MAX_LOGS if k in logs]
        device = grads[0].device
        bucket = torch.cat([g.reshape(-1) for g in grads]
                           + [torch.stack([logs[k].float() for k in means]).to(device)])
        dist.all_reduce(bucket, group=self.group)
        bucket /= self.world
        offset = 0
        for g in grads:
            g.copy_(bucket[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        for k, v in zip(means, bucket[offset:]):
            logs[k] = v
        if maxima:
            peak = torch.stack([logs[k].float() for k in maxima]).to(device)
            dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=self.group)
            for k, v in zip(maxima, peak):
                logs[k] = v


def shard(batch, rank: int, world: int):
    """Rows [rank * B / world, (rank + 1) * B / world) of every tensor of a
    batch: a tensor, or a (named) tuple of them, nested or None."""
    def cut(x):
        if x is None:
            return None
        if torch.is_tensor(x):
            n = x.shape[0] // world
            return x[rank * n:(rank + 1) * n]
        parts = [cut(y) for y in x]
        return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)

    return cut(batch)


def ddp_learn_step(policy, state, batch, group: Optional[dist.ProcessGroup] = None):
    """One data-parallel learn step: ``(state, logs, priority (B,))`` for
    the global ``batch``, which every rank holds whole, in a started
    process group (``group``, or the default one). Each rank learns on its
    contiguous shard; the batch size must divide by the world size."""
    if hasattr(policy, "task_view"):
        raise NotImplementedError(
            "ddp_learn_step does not take the multitask policies: their loss is a mean of "
            "per-task means, which ranks holding different tasks do not average to")
    if int(policy.cfg.get("accumulation_steps", 1)) > 1:
        raise NotImplementedError("ddp_learn_step does not take micro-batch accumulation")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    B = int(getattr(batch, "base", batch).obs.shape[0])
    if B % world:
        raise ValueError(f"a batch of {B} does not split over {world} ranks")
    policy.grad_sync = GradSync(group)
    try:
        state, logs, priority = policy.forward_learn(state, shard(batch, rank, world))
    finally:
        del policy.grad_sync  # back to the class's None
    parts = [torch.empty_like(priority) for _ in range(world)]
    dist.all_gather(parts, priority.contiguous(), group=group)
    return state, logs, torch.cat(parts)
