"""Sampled EfficientZero policy (``lightzero_tpu/policy/sampled_efficientzero.py``):
Sampled MuZero's K sampled candidates over EfficientZero's value-prefix
model.

The search embedding is ``{latent, sampled_actions, c, h, vp_accum,
depth}``: ``_recurrent_fn`` turns the value prefix into a reward,
``reward = vp - vp_accum``, and zeroes ``c``, ``h`` and ``vp_accum`` after
the model call at every depth that is a multiple of ``lstm_horizon_len``, as
``policy/efficientzero.py`` does. The learn step is Sampled MuZero's with
the value-prefix loss in place of the reward loss (the LSTM reset after
unroll step k+1 where k+1 is a multiple of the horizon).

Refused, as for Sampled MuZero: reanalyze (``reanalyze_ratio > 0``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import torch
from torch import nn

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.models.sampled_efficientzero import SampledEfficientZeroModel
from lightzero_tpu_torch.ops import (
    cross_entropy_loss,
    inverse_scalar_transform,
    phi_transform,
    scalar_transform,
)
from lightzero_tpu_torch.policy.sampled_muzero import (
    SampledMuZeroPolicy,
    SampledTrainBatch,
    sampled_search_prior,
)
from lightzero_tpu_torch.search.types import RecurrentOutput


class SampledEfficientZeroPolicy(SampledMuZeroPolicy):
    @staticmethod
    def default_config() -> Config:
        cfg = SampledMuZeroPolicy.default_config()
        cfg.type = "sampled_efficientzero"
        cfg.lstm_horizon_len = 5
        cfg.model.lstm_hidden_size = 256
        return cfg

    def __init__(self, cfg=None, model=None, device=None, seed: int = 0):
        super().__init__(cfg, model=model, device=device, seed=seed)
        self.lstm_horizon_len = int(self.cfg.get("lstm_horizon_len", 5))

    def _build_model(self, model_cfg: Config, generator: torch.Generator) -> nn.Module:
        return SampledEfficientZeroModel.from_config(model_cfg, generator)

    # ------------------------------------------------------------ inference
    def _root_embedding(self, out0) -> Any:
        B = out0.latent_state.shape[0]
        dev = out0.latent_state.device
        c, h = out0.reward_hidden
        return dict(
            latent=out0.latent_state,
            c=c,
            h=h,
            vp_accum=torch.zeros((B,), dtype=torch.float32, device=dev),
            depth=torch.zeros((B,), dtype=torch.int32, device=dev),
        )

    def _recurrent_fn(self, model: nn.Module, draws: Optional[Iterator[torch.Tensor]],
                      slot: torch.Tensor, emb: Any) -> RecurrentOutput:
        out = model.recurrent_inference(emb["latent"], (emb["c"], emb["h"]),
                                        self._slot_actions(emb, slot))
        vp = inverse_scalar_transform(out.value_prefix_logits, self.reward_support)
        depth = emb["depth"] + 1
        # the horizon reset (mcts_ctree.py:853-861: search_len % horizon == 0)
        reset = (depth % self.lstm_horizon_len) == 0
        c, h = out.reward_hidden
        keep = 1.0 - reset[:, None].to(c.dtype)
        new_actions, logp = self._sample_candidates(out, None if draws is None else next(draws))
        return RecurrentOutput(
            reward=vp - emb["vp_accum"],
            value=inverse_scalar_transform(out.value_logits, self.value_support),
            prior_logits=sampled_search_prior(self.cfg, logp),
            embedding=dict(
                latent=out.latent_state,
                sampled_actions=new_actions,
                c=c * keep,
                h=h * keep,
                vp_accum=torch.where(reset, 0.0, vp),
                depth=depth,
            ),
        )

    def _collect_telemetry(self, out0, visit_counts, root_actions) -> Dict[str, torch.Tensor]:
        # the JAX policy's collect returns no telemetry for this variant
        return {}

    # ---------------------------------------------------------------- learn
    def _sample_losses(self, model: nn.Module, batch: SampledTrainBatch):
        """Per-sample loss vector before importance weighting and reduction:
        ``(loss (B,), logs, value_priority (B,))`` (the JAX ``_loss_fn``,
        sampled_efficientzero.py:140-243)."""
        cfg = self.cfg
        base, sampled = batch.base, batch.sampled_actions
        K = self.num_unroll_steps
        tv_cat = phi_transform(self.value_support, scalar_transform(base.target_value))

        out0 = model.initial_inference(base.obs[:, 0])
        value_loss = cross_entropy_loss(out0.value_logits, tv_cat[:, 0])
        policy_loss, entropy = self._policy_loss(out0, sampled[:, 0], base.target_policy[:, 0])
        policy_entropy_loss = -entropy
        pred_value0 = inverse_scalar_transform(out0.value_logits.detach(), self.value_support)
        value_priority = torch.abs(pred_value0 - base.target_value[:, 0])

        latent = out0.latent_state
        reward_hidden = out0.reward_hidden
        vp_target = torch.zeros_like(base.target_reward[:, 0])
        prefix_loss = torch.zeros_like(value_loss)
        consistency_loss = torch.zeros_like(value_loss)
        for k in range(K):
            out = model.recurrent_inference(latent, reward_hidden, base.actions[:, k])
            latent = out.latent_state
            reward_hidden = out.reward_hidden
            if cfg.ssl_loss_weight > 0:
                consistency_loss = consistency_loss + self._ssl_term(
                    model, latent, base.obs[:, k + 1], base.mask[:, k])
            pl, ent = self._policy_loss(out, sampled[:, k + 1], base.target_policy[:, k + 1])
            policy_loss = policy_loss + pl
            policy_entropy_loss = policy_entropy_loss - ent
            value_loss = value_loss + cross_entropy_loss(out.value_logits, tv_cat[:, k + 1])
            # the value-prefix target: the reward sum within the horizon
            vp_target = vp_target + base.target_reward[:, k]
            vp_cat = phi_transform(self.reward_support, scalar_transform(vp_target))
            prefix_loss = prefix_loss + cross_entropy_loss(out.value_prefix_logits, vp_cat)
            if (k + 1) % self.lstm_horizon_len == 0:
                z = torch.zeros_like(reward_hidden[0])
                reward_hidden = (z, z)
                vp_target = torch.zeros_like(vp_target)

        loss = (
            cfg.ssl_loss_weight * consistency_loss
            + cfg.policy_loss_weight * policy_loss
            + cfg.value_loss_weight * value_loss
            + cfg.reward_loss_weight * prefix_loss
            + cfg.policy_entropy_weight * policy_entropy_loss
        )
        logs = dict(
            policy_loss=policy_loss.mean(),
            value_loss=value_loss.mean(),
            value_prefix_loss=prefix_loss.mean(),
            consistency_loss=consistency_loss.mean(),
            # the root's entropy, as in the JAX policy
            policy_entropy=entropy.mean(),
            predicted_value=pred_value0.mean(),
            target_value=base.target_value[:, 0].mean(),
        )
        return loss, {k: v.detach() for k, v in logs.items()}, value_priority
