"""Multitask policies (``lightzero_tpu/policy/multitask.py``, ScaleZero).

One shared model trained across tasks: ``muzero_multitask``,
``unizero_multitask`` and ``sampled_unizero_multitask``. All tasks share one
combined batch whose rows carry their task id (``MTTrainBatch``); the loss
is the task-weighted mean of the per-task means of the importance-weighted
per-sample losses (``task_loss_vector``), over the tasks present in the
batch. The model is conditioned on each row's task: MuZero's task embedding
at the root latent, the transformer's on every token.

Gradient correction (``grad_correction="cagrad"``): the (T,) vector of
weighted task losses is differentiated task by task (T backward passes over
one graph), the per-task gradients are combined conflict-aversely
(``cagrad_combine``, arXiv:2110.14048) from their T x T Gram matrix, and
the optimizer takes the combined gradient through the same global-norm
clip as the default path. As in the JAX policy, this step skips UniZero's
extras: micro-batch accumulation, the non-finite guard, the ``log_alpha``
clamp, Encoder-Clip and Head-Clip. It logs ``task{t}_cagrad_w``, weights
on the simplex.

Collection, evaluation and the replay buffer's bootstrap values run on a
``task_view``: a shallow copy that shares the model and binds its task id.
"""
from __future__ import annotations

import copy
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from lightzero_tpu_torch.config import Config, deep_merge
from lightzero_tpu_torch.policy.muzero import MuZeroPolicy, TrainState
from lightzero_tpu_torch.policy.sampled_unizero import SampledUniZeroPolicy
from lightzero_tpu_torch.policy.unizero import UniZeroPolicy


class MTTrainBatch(NamedTuple):
    """A ``TrainBatch`` with the multitask fields, which every base
    ``_sample_losses`` reads as a ``TrainBatch``.

    task_id: (B,) int64, each row's task
    task_weights: (T,) float32, the cross-task loss weights
    """

    obs: torch.Tensor
    actions: torch.Tensor
    mask: torch.Tensor
    target_reward: torch.Tensor
    target_value: torch.Tensor
    target_policy: torch.Tensor
    weights: torch.Tensor
    chance: Optional[torch.Tensor] = None
    task_id: Optional[torch.Tensor] = None
    task_weights: Optional[torch.Tensor] = None


def attach_task_fields(batch, task_id, task_weights):
    """``batch`` with the multitask fields, on the batch's device; a batch
    that wraps a ``base`` (``SampledTrainBatch``) gets them on its base."""
    if hasattr(batch, "base"):
        return batch._replace(base=attach_task_fields(batch.base, task_id, task_weights))
    dev = batch.obs.device
    return MTTrainBatch(*batch, task_id=torch.as_tensor(task_id, dtype=torch.long, device=dev),
                        task_weights=torch.as_tensor(task_weights, dtype=torch.float32,
                                                     device=dev))


def mt_fields(batch) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """(task_id, task_weights, weights) of a batch or of its base. A batch
    without the fields raises AttributeError, as the JAX policy does."""
    tb = getattr(batch, "base", batch)
    return tb.task_id, tb.task_weights, tb.weights


def task_loss_vector(loss_vec: torch.Tensor, weights: torch.Tensor, task_id: torch.Tensor,
                     num_tasks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-task means of the importance-weighted per-sample losses, (T,)
    with zeros for the tasks absent from the batch, and the per-task sample
    counts (T,)."""
    wl = weights * loss_vec
    onehot = nn.functional.one_hot(task_id.long(), num_tasks).to(wl.dtype)  # (B, T)
    n = onehot.sum(dim=0)
    return (onehot * wl[:, None]).sum(dim=0) / torch.clamp(n, min=1.0), n


def cagrad_combine(task_grads: Sequence[torch.Tensor], c: float = 0.4, gd_steps: int = 25
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Conflict-averse combination of per-task gradients (CAGrad).

    ``task_grads``: one tensor per parameter, each with a leading task axis
    T. With g0 = mean_t g_t and g_w = sum_t w_t g_t it solves
    min over the simplex of g_w . g0 + c |g0| |g_w| by ``gd_steps`` steps of
    0.5 on softmax logits, all through the T x T Gram matrix M, and returns
    the per-parameter combination sum_t (1/T + lambda w_t) g_t with
    lambda = c |g0| / |g_w|, and w."""
    T = task_grads[0].shape[0]
    G = torch.cat([g.reshape(T, -1) for g in task_grads], dim=1)
    M = G @ G.T
    ones = torch.full((T,), 1.0 / T, dtype=M.dtype, device=M.device)
    g0_norm = torch.sqrt(torch.clamp(ones @ M @ ones, min=1e-12))
    u = M @ ones
    z = torch.zeros(T, dtype=M.dtype, device=M.device)
    for _ in range(gd_steps):
        w = torch.softmax(z, dim=0)
        mw = M @ w
        q = w @ mw
        # d/dw of w.u + c |g0| sqrt(max(q, 1e-12)), then through the softmax
        dw = u + torch.where(q > 1e-12, c * g0_norm * mw / torch.sqrt(torch.clamp(q, min=1e-12)),
                             torch.zeros_like(mw))
        z = z - 0.5 * w * (dw - w @ dw)
    w = torch.softmax(z, dim=0)
    gw_norm = torch.sqrt(torch.clamp(w @ M @ w, min=1e-12))
    alpha = ones + (c * g0_norm / gw_norm) * w
    return [torch.tensordot(alpha, g, dims=1) for g in task_grads], w


class MultitaskMixin:
    """Put ahead of a base policy, whose ``_sample_losses(model, batch,
    task_id=, train_iter=)`` gives ``(loss (B,), extra, logs, priority)``."""

    @classmethod
    def _mt_default_config(cls, base_cfg: Config, type_name: str) -> Config:
        base_cfg.type = type_name
        base_cfg.task_num = 2
        # 'none': the weighted per-task means; 'cagrad': the conflict-averse
        # combination of the per-task gradients
        base_cfg.grad_correction = "none"
        base_cfg.cagrad_c = 0.4
        base_cfg.model.num_tasks = 2  # the task-embedding table, >= task_num
        return base_cfg

    def __init__(self, cfg=None, model=None, device=None, seed: int = 0):
        cfg = deep_merge(self.default_config(), cfg or {})
        self.task_num = int(cfg.get("task_num", 2))
        if int(cfg.model.get("num_tasks", 0)) < self.task_num:
            cfg.model.num_tasks = self.task_num
        self.grad_correction = str(cfg.get("grad_correction", "none"))
        if self.grad_correction not in ("none", "cagrad"):
            raise ValueError(f"unknown grad_correction {self.grad_correction!r}")
        super().__init__(cfg, model=model, device=device, seed=seed)

    # ---------------------------------------------------------------- learn
    def _task_terms(self, model: nn.Module, batch, train_iter):
        """(per-task losses (T,), presence (T,), task weights (T,), extra,
        logs, value priority (B,))."""
        task_id, task_weights, weights = mt_fields(batch)
        loss_vec, extra, logs, vp = self._sample_losses(
            model, batch, task_id=task_id, train_iter=0 if train_iter is None else train_iter)
        task_loss, n = task_loss_vector(loss_vec, weights, task_id, self.task_num)
        present = (n > 0).to(task_loss.dtype)
        if task_weights is None:
            task_weights = torch.ones_like(task_loss)
        return task_loss, present, task_weights, extra, logs, vp

    def _loss_fn(self, model: nn.Module, batch, train_iter=None):
        """The task-weighted mean of the present tasks' losses, plus the
        batch terms; per-task losses and weights logged."""
        task_loss, present, tw, extra, logs, vp = self._task_terms(model, batch, train_iter)
        total = (tw * task_loss * present).sum() / torch.clamp(present.sum(), min=1.0) + extra
        logs["total_loss"] = total.detach()
        for t in range(self.task_num):
            logs[f"task{t}_loss"] = task_loss[t].detach()
            logs[f"task{t}_weight"] = tw[t].detach()
        return total / self.num_unroll_steps, (logs, vp)

    def forward_learn(self, state: TrainState, batch):
        if self.grad_correction != "cagrad":
            return super().forward_learn(state, batch)
        return self._forward_learn_cagrad(state, batch)

    def _forward_learn_cagrad(self, state: TrainState, batch):
        """One step on the CAGrad combination of the per-task gradients,
        through the default path's clip; UniZero's extras are skipped."""
        model = state.model
        task_loss, present, tw, extra, logs, vp = self._task_terms(model, batch, state.train_iter)
        # per-task objectives, the batch terms spread evenly over the tasks
        vec = ((tw * task_loss * present) / torch.clamp(present.sum(), min=1.0)
               + extra / self.task_num) / self.num_unroll_steps
        params = list(model.parameters())
        per_task = []
        for t in range(self.task_num):
            g = torch.autograd.grad(vec[t], params, retain_graph=t < self.task_num - 1,
                                    allow_unused=True)
            per_task.append([torch.zeros_like(p) if gi is None else gi
                             for gi, p in zip(g, params)])
        grads, cag_w = cagrad_combine([torch.stack(gs) for gs in zip(*per_task)],
                                      float(self.cfg.get("cagrad_c", 0.4)))
        for p, g in zip(params, grads):
            p.grad = g
        logs["grad_norm"] = torch.nn.utils.get_total_norm(grads)
        # the clip covers what the optimizer updates, log_alpha's group aside
        state, _ = self._update(state, [p.grad for grp in state.optimizer.param_groups
                                        if not grp.get("alpha", False) for p in grp["params"]])
        logs["total_loss"] = task_loss.sum().detach()
        for t in range(self.task_num):
            logs[f"task{t}_loss"] = task_loss[t].detach()
            logs[f"task{t}_weight"] = tw[t].detach()
            logs[f"task{t}_cagrad_w"] = cag_w[t].detach()
        return state, logs, vp

    # -------------------------------------------------------------- workers
    def task_view(self, task_id: int):
        """A shallow copy of this policy bound to ``task_id`` for a task's
        collector, evaluator and buffer: it shares the model, the config and
        the generator, and conditions its searches, bootstrap values and
        reanalyze on the task."""
        view = copy.copy(self)
        view._collect_task_id = int(task_id)
        return view


class MuZeroMTPolicy(MultitaskMixin, MuZeroPolicy):
    """MuZero across tasks: a task embedding added to the root latent."""

    @staticmethod
    def default_config() -> Config:
        return MultitaskMixin._mt_default_config(MuZeroPolicy.default_config(),
                                                 "muzero_multitask")

    def _sample_losses(self, model, batch, task_id=None, train_iter=None):
        """MuZero's per-sample losses with the HarmonyDream regularizer as
        the batch term (zero without ``harmony_balance``), as the JAX
        policy's."""
        loss, logs, vp = super()._sample_losses(model, batch, task_id=task_id)
        return loss, self._harmony_regularizer(model), logs, vp


class UniZeroMTPolicy(MultitaskMixin, UniZeroPolicy):
    """UniZero across tasks: one task-conditioned transformer world model."""

    @staticmethod
    def default_config() -> Config:
        return MultitaskMixin._mt_default_config(UniZeroPolicy.default_config(),
                                                 "unizero_multitask")


class SampledUniZeroMTPolicy(MultitaskMixin, SampledUniZeroPolicy):
    """Sampled UniZero across tasks (ScaleZero), with curriculum LoRA stages
    switched by the balance entry."""

    @staticmethod
    def default_config() -> Config:
        return MultitaskMixin._mt_default_config(SampledUniZeroPolicy.default_config(),
                                                 "sampled_unizero_multitask")
