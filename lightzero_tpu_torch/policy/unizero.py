"""UniZero policy (``lightzero_tpu/policy/unizero.py``): the transformer
world model of ``models/unizero.py`` searched with the pUCT search.

Serving: collection and evaluation keep a per-env KV cache across real env
steps (``stateful_collect``): each step appends the observation's token,
searches from there, and appends the chosen action's token only, the real
next observation arriving at the next step. The search's node embedding is
``{"cache": KVCache}``, one copy of the cache per node; a simulation appends
the action's token and then the predicted observation's. The search is
one-player and non-stochastic, so every simulation's descent is one launch
of the descent kernel (``fused_traverse``) on the card. ``forward_collect``
and ``forward_eval`` search from a fresh context holding the observation
alone (the JAX policy has no stateless collect); ``forward_reanalyze``
searches from a fresh context, or from a ``prefill`` of the stored
(obs, action) history when the buffer passes one.

Training: one pass over the interleaved sequence gives the value, policy and
reward cross-entropies and the next-latent loss (``predict_latent_loss``:
MSE or the SimNorm groups' KL), the policy-entropy term, with the adaptive
temperature ``log_alpha`` (its own Adam) against a target entropy annealed
by ``train_iter``; the optional reconstruction loss through the decoder,
with the LPIPS perceptual term (``ops/lpips.py``, a frozen VGG trunk that
the policy holds) on image observations when ``perceptual_loss_weight`` >
0; the drift correction, passes that feed the model's own predicted
embeddings back as obs tokens, to ``drift_correction_depth``. The learn
step accumulates gradients over ``accumulation_steps`` micro-batches, skips
a step whose loss or gradients are not finite (params, optimizer state and
learning-rate schedule untouched), clamps ``log_alpha`` to
[log 0.05, log 10], rescales the encoder (Encoder-Clip) and the heads
(Head-Clip) by their annealed thresholds, and copies the target network
every ``target_update_freq`` steps. The optimizer is AdamW with the
selective decay, ``log_alpha`` in a group of its own at
``adaptive_entropy_alpha_lr``, and with CurriculumLoRA on only the stage's
trainable parameters (``curriculum_trainable_mask``).

Deliberate difference: on a non-finite step the JAX policy still applies
Encoder-Clip and Head-Clip, whose scale is then min(1, threshold / NaN) =
NaN and overwrites the encoder or heads with NaN (ROADMAP queue 3); here
the clips run only on the steps that update.

Multitask: a task view (``policy/multitask.py``) conditions every token of
its searches, its bootstrap values and its reanalyze prefill on its task;
``_sample_losses`` takes the batch's task ids. ``set_curriculum_stage``
switches the CurriculumLoRA stage in place and rebuilds the optimizer over
the new stage's trainable parameters.

Refused with ``NotImplementedError``: another ``optim_type`` than AdamW (no
UniZero config sets one).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.models.unizero import UniZeroModel
from lightzero_tpu_torch.models.unizero_world_model.transformer import (
    CurriculumLoRADense,
    KVCache,
    curriculum_trainable_mask,
)
from lightzero_tpu_torch.ops import (
    cross_entropy_loss,
    inverse_scalar_transform,
    phi_transform,
    scalar_transform,
)
from lightzero_tpu_torch.ops.lpips import LPIPS
from lightzero_tpu_torch.policy.muzero import (
    MuZeroPolicy,
    TrainBatch,
    TrainState,
    zero_missing_grads_,
)
from lightzero_tpu_torch.search.puct import batch_puct_search
from lightzero_tpu_torch.search.types import RecurrentOutput, RootOutput
from lightzero_tpu_torch.utils import profiling


def predict_latent_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                        loss_type: str, group_size: int = 8) -> torch.Tensor:
    """(B, K, D) predicted and target latents -> (B,) masked sum over the
    unroll steps: the mean squared error, or ('group_kl') the KL within each
    SimNorm group, averaged over the groups."""
    if loss_type == "group_kl":
        eps = 1e-6
        B, K, D = pred.shape
        p = pred.reshape(B, K, D // group_size, group_size) + eps
        t = target.reshape(B, K, D // group_size, group_size) + eps
        kl = torch.sum(t * (torch.log(t) - torch.log(p)), dim=-1).mean(dim=-1)
        return torch.sum(kl * mask, dim=-1)
    return torch.sum(torch.mean((pred - target) ** 2, dim=-1) * mask, dim=-1)


def annealed(start: float, end: float, steps: int, kind: str, it: int) -> float:
    """Cosine (or linear) interpolation from ``start`` to ``end`` over
    ``steps`` iterations, held at ``end`` after."""
    progress = min(1.0, it / float(steps))
    if kind == "cosine":
        return end + (start - end) * 0.5 * (1.0 + math.cos(math.pi * progress))
    return start * (1.0 - progress) + end * progress


class UniZeroPolicy(MuZeroPolicy):
    # its JAX policy replaces MuZero's loss and has no HarmonyDream term
    harmony_loss = False
    stateful_collect = True
    # the buffer passes the stored (obs, action) history to reanalyze
    reanalyze_needs_context = True

    @staticmethod
    def default_config() -> Config:
        """The JAX policy's defaults (``lightzero_tpu/policy/unizero.py:64``)."""
        cfg = MuZeroPolicy.default_config()
        cfg.type = "unizero"
        cfg.num_unroll_steps = 10
        cfg.model.embed_dim = 256
        cfg.model.num_layers = 2
        cfg.model.num_heads = 8
        cfg.model.max_tokens = 32
        cfg.obs_loss_weight = 10.0
        cfg.predict_latent_loss_type = "mse"
        cfg.target_update_freq = 100
        cfg.latent_recon_loss_weight = 0.0
        cfg.perceptual_loss_weight = 0.0
        cfg.use_adaptive_entropy_weight = True
        cfg.target_entropy_start_ratio = 0.98
        cfg.target_entropy_end_ratio = 0.05
        cfg.target_entropy_decay_steps = int(1e5)
        cfg.adaptive_entropy_alpha_lr = 1e-3
        cfg.use_encoder_clip_annealing = False
        cfg.encoder_clip_start = 30.0
        cfg.encoder_clip_end = 10.0
        cfg.encoder_clip_anneal_steps = int(1e5)
        cfg.encoder_clip_anneal_type = "cosine"
        cfg.use_head_clip = False
        cfg.head_clip_start = 30.0
        cfg.head_clip_end = 15.0
        cfg.head_clip_anneal_steps = int(1e5)
        cfg.head_clip_anneal_type = "cosine"
        cfg.selective_weight_decay = True
        cfg.weight_decay = 1e-4
        cfg.optim_type = "AdamW"
        cfg.learning_rate = 1e-4
        cfg.accumulation_steps = 1
        cfg.reanalyze_context_steps = 4
        cfg.drift_correction_weight = 0.0
        cfg.drift_correction_depth = 1
        return cfg

    def __init__(self, cfg=None, model=None, device=None, seed: int = 0):
        super().__init__(cfg, model=model, device=device, seed=seed)
        # the frozen LPIPS trunk of the perceptual term: the policy's, not
        # the model's, so that it is in no optimizer and no state dict
        self.lpips = None
        if (float(self.cfg.get("perceptual_loss_weight", 0.0)) > 0
                and float(self.cfg.get("latent_recon_loss_weight", 0.0)) > 0):
            self.lpips = LPIPS(self.device)

    def _build_model(self, model_cfg: Config, generator: torch.Generator) -> nn.Module:
        if float(self.cfg.get("latent_recon_loss_weight", 0.0)) > 0:
            model_cfg.with_decoder = True
        return UniZeroModel.from_config(model_cfg, generator)

    # ------------------------------------------------------------ optimizer
    def _make_optimizer(self, model: nn.Module):
        """AdamW (selective decay: rank >= 2 tensors only), clipped in the
        learn step; ``log_alpha`` in a group of its own, plain Adam at
        ``adaptive_entropy_alpha_lr`` with no schedule, under the adaptive
        entropy; under CurriculumLoRA only the stage's trainable
        parameters."""
        cfg = self.cfg
        if cfg.optim_type != "AdamW":
            raise NotImplementedError(
                f"optim_type {cfg.optim_type!r} is not ported for UniZero: its optimizer is "
                "AdamW, the JAX policy's default and the one every UniZero config uses")
        named = dict(model.named_parameters())
        mcfg = cfg.model
        if int(mcfg.get("lora_r", 0)) > 0 and int(mcfg.get("curriculum_stage_num", 1)) > 1:
            train = curriculum_trainable_mask(list(named), model.tcfg.curriculum_stage)
            named = {k: p for k, p in named.items() if train[k]}
        adaptive = bool(cfg.get("use_adaptive_entropy_weight", False))
        alpha = [named.pop("log_alpha")] if adaptive and "log_alpha" in named else []
        wd = float(cfg.weight_decay)
        selective = bool(cfg.get("selective_weight_decay", False))
        params = list(named.values())
        groups = [dict(params=[p for p in params if p.ndim >= 2 or not selective],
                       weight_decay=wd),
                  dict(params=[p for p in params if p.ndim < 2 and selective], weight_decay=0.0)]
        schedule = self._lr_schedule()
        lambdas = [schedule, schedule]
        if alpha:
            groups.append(dict(params=alpha, weight_decay=0.0, alpha=True,
                               lr=float(cfg.get("adaptive_entropy_alpha_lr", 1e-3))))
            lambdas.append(lambda count: 1.0)
        opt = torch.optim.AdamW(groups, lr=float(cfg.learning_rate), eps=1e-8)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambdas)

    def set_curriculum_stage(self, stage: int, state: Optional[TrainState] = None
                             ) -> Optional[TrainState]:
        """Switch the CurriculumLoRA stage of the policy's model (and of
        ``state``'s target copy) in place, and return ``state`` with a fresh
        optimizer and learning-rate schedule over the stage's trainable
        parameters (the JAX policy rebuilds its optimizer and the entry
        re-inits ``opt_state``, whose schedule count starts again at 0).
        Every task view shares the model, so it follows."""
        models = [self.model] + ([state.target_model] if state is not None else [])
        for model in models:
            model.tcfg = dataclasses.replace(model.tcfg, curriculum_stage=int(stage))
            for m in model.modules():
                if isinstance(m, CurriculumLoRADense):
                    m.stage = int(stage)
        if state is None:
            return None
        optimizer, lr_scheduler = self._make_optimizer(state.model)
        return state._replace(optimizer=optimizer, lr_scheduler=lr_scheduler)

    # ---------------------------------------------------------- collect state
    def _fresh_cache(self, batch_size: int, model: Optional[nn.Module] = None) -> KVCache:
        return (model or self.model).init_cache(batch_size, self.device)

    def init_collect_state(self, batch_size: int) -> KVCache:
        """One empty KV cache per env."""
        return self._fresh_cache(batch_size)

    def reset_collect_state(self, state: KVCache, done: torch.Tensor) -> KVCache:
        """Empty the caches of the envs whose episode ended."""
        fresh = self._fresh_cache(done.shape[0])
        done = done.to(self.device)
        return KVCache(*(torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), f, a)
                         for f, a in zip(fresh, state)))

    # ------------------------------------------------------------ inference
    def _recurrent_fn(self, model: nn.Module, action: torch.Tensor, emb: Any) -> RecurrentOutput:
        tid = self._task_ids(action.shape[0])
        a_out, cache = model.infer_action_step(emb["cache"], action, tid)
        o_out, cache = model.infer_obs_step(cache, a_out["obs_pred"], tid)
        return RecurrentOutput(
            reward=inverse_scalar_transform(a_out["reward_logits"], self.reward_support),
            value=inverse_scalar_transform(o_out["value_logits"], self.value_support),
            prior_logits=o_out["policy_logits"],
            embedding=dict(cache=cache),
        )

    def _root(self, model: nn.Module, obs: torch.Tensor, context: KVCache):
        """The obs token appended to ``context``: (root, cache)."""
        o_out, cache = model.infer_obs_step(context, model.encode_obs(obs),
                                            self._task_ids(obs.shape[0]))
        root = RootOutput(
            prior_logits=o_out["policy_logits"],
            value=inverse_scalar_transform(o_out["value_logits"], self.value_support),
            embedding=dict(cache=cache),
        )
        return root, cache

    @torch.no_grad()
    def _forward_collect_stateful(
        self,
        obs: torch.Tensor,
        legal_mask: torch.Tensor,
        to_play: torch.Tensor,
        temperature: float,
        epsilon: float,
        collect_state: KVCache,
        deterministic: bool = False,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[Dict[str, torch.Tensor], KVCache]:
        """Search from the context with the observation appended and act;
        the next context is this one with the chosen action appended.
        ``noise`` (B, A) replaces the Dirichlet draw (for tests)."""
        profiling.new_request()
        obs = obs.to(self.device, torch.float32)
        root, cache = self._root(self.model, obs, collect_state)
        out = self._search_and_act(root, legal_mask.to(self.device), to_play, temperature,
                                   epsilon, deterministic, noise=noise)
        _, new_state = self.model.infer_action_step(cache, out["action"],
                                                    self._task_ids(obs.shape[0]))
        return out, new_state

    @torch.no_grad()
    def _forward_collect(self, obs, legal_mask, to_play, temperature, epsilon,
                         deterministic: bool = False, **draws) -> Dict[str, torch.Tensor]:
        """A search from a fresh context that holds the observation alone;
        ``draws`` (``noise``, and the sampled policy's candidate draws) go to
        ``_forward_collect_stateful``."""
        out, _ = self._forward_collect_stateful(
            obs, legal_mask, to_play, temperature, epsilon, self.init_collect_state(obs.shape[0]),
            deterministic=deterministic, **draws)
        return out

    @torch.no_grad()
    def _bootstrap_value_fn(self, target_model: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        """The value of a fresh context holding the observation alone."""
        root, _ = self._root(target_model, obs, self._fresh_cache(obs.shape[0], target_model))
        return root.value

    @torch.no_grad()
    def forward_reanalyze(
        self, target_model, obs, legal_mask, to_play=None, generator=None, true_action=None,
        reuse_value=None, noise=None, obs_hist=None, act_hist=None, hist_len=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Search again with the target network: (normalised root visits,
        root values). The root's context is the ``prefill`` of the history
        (``obs_hist`` (B, H+1, *obs), ``act_hist`` (B, H), ``hist_len`` (B,))
        when given, else the observation alone. ``noise`` (B, A) replaces the
        Dirichlet draw (for tests)."""
        if true_action is not None:
            raise NotImplementedError("UniZero's reanalyze has no reuse search (the JAX policy "
                                      "ignores true_action and reuse_value)")
        profiling.new_request()
        dev = self.device
        obs = obs.to(dev, torch.float32)
        if obs_hist is not None:
            o_out, cache = target_model.prefill(obs_hist.to(dev, torch.float32),
                                                act_hist.to(dev), hist_len.to(dev),
                                                self._task_ids(obs.shape[0]))
            root = RootOutput(
                prior_logits=o_out["policy_logits"],
                value=inverse_scalar_transform(o_out["value_logits"], self.value_support),
                embedding=dict(cache=cache))
        else:
            root, _ = self._root(target_model, obs, self._fresh_cache(obs.shape[0], target_model))
        search_out = batch_puct_search(
            root,
            lambda action, emb: self._recurrent_fn(target_model, action, emb),
            self.search_cfg,
            legal_mask.to(dev),
            to_play=self._to_play(obs, to_play).to(dev),
            with_noise=bool(self.cfg.get("reanalyze_noise", True)),
            noise=noise,
            generator=generator or self.generator,
            device=dev,
        )
        counts = search_out.visit_counts.to(torch.float32)
        return counts / torch.clamp(counts.sum(-1, keepdim=True), min=1e-9), search_out.root_value

    # ---------------------------------------------------------------- learn
    def _sample_losses(self, model: nn.Module, batch: TrainBatch,
                       task_id: Optional[torch.Tensor] = None, train_iter: int = 0):
        """Per-sample loss before importance weighting, the terms added once
        per batch (the alpha loss and the weighted reconstruction loss), the
        logs and the priorities: ``(loss (B,), extra, logs, value_priority)``.
        ``task_id`` (B,) conditions the world model's tokens (None: task 0
        where the model has a task table)."""
        cfg = self.cfg
        tv_cat = phi_transform(self.value_support, scalar_transform(batch.target_value))
        tr_cat = phi_transform(self.reward_support, scalar_transform(batch.target_reward))
        out = model.train_forward(batch.obs, batch.actions, task_id)
        value_loss = cross_entropy_loss(out["value_logits"], tv_cat).sum(-1)
        policy_loss = cross_entropy_loss(out["policy_logits"], batch.target_policy).sum(-1)
        reward_loss = cross_entropy_loss(out["reward_logits"], tr_cat).sum(-1)
        obs_loss = predict_latent_loss(out["obs_pred"], out["obs_embeddings"][:, 1:].detach(),
                                       batch.mask, str(cfg.get("predict_latent_loss_type", "mse")))
        prob = torch.softmax(out["policy_logits"][:, 0], dim=-1)
        entropy = -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-9)), dim=-1)
        pred_value0 = inverse_scalar_transform(out["value_logits"][:, 0].detach(),
                                               self.value_support)
        value_priority = torch.abs(pred_value0 - batch.target_value[:, 0])
        zero = torch.zeros((), device=value_loss.device)

        alpha_loss = zero
        entropy_weight = torch.full((), float(cfg.policy_entropy_weight), device=zero.device)
        if bool(cfg.get("use_adaptive_entropy_weight", False)):
            # alpha_loss = log_alpha (H - H_target); the policy term takes
            # alpha = exp(log_alpha) without its gradient
            progress = min(1.0, float(train_iter) / float(cfg.target_entropy_decay_steps))
            ratio = (float(cfg.target_entropy_start_ratio) * (1.0 - progress)
                     + float(cfg.target_entropy_end_ratio) * progress)
            target_entropy = math.log(float(cfg.model.action_space_size)) * ratio
            alpha_loss = model.log_alpha * (entropy.mean() - target_entropy).detach()
            entropy_weight = torch.exp(model.log_alpha).detach()

        recon_w = float(cfg.get("latent_recon_loss_weight", 0.0))
        latent_recon_loss = zero
        if recon_w > 0:
            B, K1 = batch.obs.shape[:2]
            recon = model.decode_obs(out["obs_embeddings"].reshape(B * K1, -1))
            obs_flat = batch.obs.reshape((B * K1,) + batch.obs.shape[2:])
            latent_recon_loss = torch.mean((recon - obs_flat) ** 2)
            pw = float(cfg.get("perceptual_loss_weight", 0.0))
            if pw > 0 and recon.ndim == 4:  # image observations only: NHWC, as in JAX
                latent_recon_loss = latent_recon_loss + (pw / recon_w) * torch.mean(
                    self.lpips(torch.clamp(recon, 0.0, 1.0), torch.clamp(obs_flat, 0.0, 1.0)))

        dc_w = float(cfg.get("drift_correction_weight", 0.0))
        dc_depth = int(cfg.get("drift_correction_depth", 1))
        dc_reward_loss = zero
        loss = (cfg.policy_loss_weight * policy_loss + cfg.value_loss_weight * value_loss
                + cfg.reward_loss_weight * reward_loss + cfg.obs_loss_weight * obs_loss
                + entropy_weight * (-entropy))
        if dc_w > 0:
            # pass d feeds pass d-1's predicted embeddings (without their
            # gradient) as the obs tokens 1..K
            drift_loss = torch.zeros_like(value_loss)
            prev = out
            for _ in range(dc_depth):
                obs_ed = torch.cat([out["obs_embeddings"][:, :1], prev["obs_pred"].detach()],
                                   dim=1)
                outd = model.train_forward_embedded(obs_ed, batch.actions, task_id)
                dc_reward = cross_entropy_loss(outd["reward_logits"], tr_cat).sum(-1)
                dc_value = cross_entropy_loss(outd["value_logits"][:, 1:], tv_cat[:, 1:]).sum(-1)
                dc_policy = cross_entropy_loss(outd["policy_logits"][:, 1:],
                                               batch.target_policy[:, 1:]).sum(-1)
                drift_loss = drift_loss + (cfg.reward_loss_weight * dc_reward
                                           + cfg.value_loss_weight * dc_value
                                           + cfg.policy_loss_weight * dc_policy) / dc_depth
                dc_reward_loss = dc_reward_loss + dc_reward.mean() / dc_depth
                prev = outd
            loss = loss + dc_w * drift_loss
        extra = alpha_loss + recon_w * latent_recon_loss
        emb = out["obs_embeddings"].detach()
        logs = dict(
            policy_loss=policy_loss.mean(),
            value_loss=value_loss.mean(),
            reward_loss=reward_loss.mean(),
            obs_loss=obs_loss.mean(),
            latent_recon_loss=latent_recon_loss,
            dc_reward_loss=dc_reward_loss,
            alpha_loss=alpha_loss,
            entropy_weight=entropy_weight,
            latent_norm_max=torch.linalg.vector_norm(emb, dim=-1).max(),
            latent_batch_std=torch.std(emb.reshape(-1, emb.shape[-1]), dim=0,
                                       unbiased=False).mean(),
            policy_logits_max=out["policy_logits"].abs().max(),
            value_logits_max=out["value_logits"].abs().max(),
            reward_logits_max=out["reward_logits"].abs().max(),
            policy_entropy=entropy.mean(),
            predicted_value=pred_value0.mean(),
            target_value=batch.target_value[:, 0].mean(),
        )
        return loss, extra, {k: v.detach() for k, v in logs.items()}, value_priority

    def _loss_fn(self, model: nn.Module, batch, train_iter: int = 0):
        loss, extra, logs, value_priority = self._sample_losses(model, batch,
                                                                train_iter=train_iter)
        weights = getattr(batch, "base", batch).weights
        weighted_total_loss = torch.mean(weights * loss) + extra
        logs["total_loss"] = weighted_total_loss.detach()
        return weighted_total_loss / self.num_unroll_steps, (logs, value_priority)

    @staticmethod
    def _micro_batches(batch, steps: int):
        """``steps`` consecutive slices of a (possibly nested) batch."""
        def cut(x, i):
            if x is None:
                return None
            if torch.is_tensor(x):
                micro = x.shape[0] // steps
                return x[i * micro:(i + 1) * micro]
            return type(x)(*(cut(y, i) for y in x))

        return [cut(batch, i) for i in range(steps)]

    def forward_learn(self, state: TrainState, batch):
        """One UniZero learn step: ``(state, logs, value_priority (B,))``.
        Its spans: ``learn.forward`` and ``learn.backward`` once a
        micro-batch, then ``learn.readback`` and ``learn.optimizer``."""
        profiling.new_request()
        cfg = self.cfg
        model = state.model
        steps = int(cfg.get("accumulation_steps", 1))
        micro = self._micro_batches(batch, steps) if steps > 1 else [batch]
        named = dict(model.named_parameters())
        logs_m, prio_m = [], []
        for i, mb in enumerate(micro):
            with profiling.span("learn.forward"):
                if i == 0:
                    # every parameter's, not only the optimizer's: under
                    # CurriculumLoRA the frozen ones get gradients too, which
                    # the logged norm and the non-finite guard read
                    model.zero_grad(set_to_none=True)
                loss, (lg, vp) = self._loss_fn(model, mb, state.train_iter)
            with profiling.span("learn.backward"):
                (loss / len(micro)).backward()
                zero_missing_grads_(named.values())
            logs_m.append(lg)
            prio_m.append(vp)
        logs = {k: torch.stack([lg[k] for lg in logs_m]).mean() for k in logs_m[0]}
        value_priority = torch.cat(prio_m)
        if self.grad_sync is not None:
            # a non-finite loss or gradient on any rank makes the averages
            # non-finite on every rank, so all of them skip the step together
            self.grad_sync(list(named.values()), logs)
        with profiling.span("learn.readback"):
            # the norm is non-finite where any gradient is: one read-back
            grad_norm = torch.nn.utils.get_total_norm([p.grad for p in named.values()])
            finite = bool(torch.isfinite(logs["total_loss"]) & torch.isfinite(grad_norm))
            logs["nonfinite_loss"] = torch.tensor(float(not finite), device=self.device)
        if not finite:
            for p in named.values():
                p.grad.zero_()
            grad_norm = torch.zeros_like(grad_norm)
        logs["grad_norm"] = grad_norm
        logs["cur_lr"] = state.lr_scheduler.get_last_lr()[0]
        # clip the model groups' gradients (not log_alpha's) as optax does
        model_grads = [p.grad for grp in state.optimizer.param_groups
                       if not grp.get("alpha", False) for p in grp["params"]] if finite else None
        state, _ = self._update(state, model_grads,
                                functools.partial(self._after_step, model, logs, state.train_iter))
        return state, logs, value_priority

    @torch.no_grad()
    def _after_step(self, model: nn.Module, logs: Dict[str, torch.Tensor], it: int) -> None:
        """The log_alpha clamp, Encoder-Clip and Head-Clip after an update."""
        cfg = self.cfg
        if bool(cfg.get("use_adaptive_entropy_weight", False)):
            model.log_alpha.clamp_(math.log(5e-2), math.log(10.0))
        if bool(cfg.get("use_encoder_clip_annealing", False)):
            clip_v = annealed(float(cfg.encoder_clip_start), float(cfg.encoder_clip_end),
                              int(cfg.encoder_clip_anneal_steps),
                              str(cfg.get("encoder_clip_anneal_type", "cosine")), it)
            scale = torch.clamp(clip_v / torch.clamp(logs["latent_norm_max"], min=1e-9), max=1.0)
            for name in ("encoder", "encoder_conv", "encoder_proj"):
                if hasattr(model, name):
                    for p in getattr(model, name).parameters():
                        p.mul_(scale)
            logs["encoder_clip_scale"] = scale
        if bool(cfg.get("use_head_clip", False)):
            thr = annealed(float(cfg.head_clip_start), float(cfg.head_clip_end),
                           int(cfg.head_clip_anneal_steps),
                           str(cfg.get("head_clip_anneal_type", "cosine")), it)
            for head, key in (("policy_head", "policy_logits_max"),
                              ("value_head", "value_logits_max"),
                              ("reward_head", "reward_logits_max")):
                hscale = torch.clamp(thr / torch.clamp(logs[key], min=1e-9), max=1.0)
                for p in getattr(model, head).parameters():
                    p.mul_(hscale)
                logs[f"head_clip_scale/_{head}"] = hscale
