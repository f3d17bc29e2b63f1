"""MuZero-RNN-full-obs policy (``lightzero_tpu/policy/muzero_rnn_full_obs.py``).

The GRU history of ``MuZeroRNNModel`` rides the search embedding as
``dict(latent, history)``, as EfficientZero's LSTM state does, so the search
is the pUCT search unchanged and runs the descent kernel. The learn step
unrolls the model with the history threaded through the unroll, with the SSL
consistency loss whenever ``ssl_loss_weight > 0`` (the model always has the
projector).

The model's ``from_config`` refuses a conv model: the JAX model has none
(ROADMAP queue 3).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.models.muzero_rnn import MuZeroRNNModel
from lightzero_tpu_torch.ops import (
    cross_entropy_loss,
    inverse_scalar_transform,
    phi_transform,
    scalar_transform,
)
from lightzero_tpu_torch.policy.muzero import MuZeroPolicy, TrainBatch, negative_cosine_similarity
from lightzero_tpu_torch.search.types import RecurrentOutput


class MuZeroRNNFullObsPolicy(MuZeroPolicy):
    # its JAX policy replaces MuZero's loss and has no HarmonyDream term
    harmony_loss = False

    @staticmethod
    def default_config() -> Config:
        cfg = MuZeroPolicy.default_config()
        cfg.type = "muzero_rnn_full_obs"
        cfg.model.rnn_hidden_size = 128
        cfg.model.self_supervised_learning_loss = True
        cfg.ssl_loss_weight = 2.0
        return cfg

    def _build_model(self, model_cfg: Config, generator: torch.Generator) -> nn.Module:
        # both supports are 2 * support_scale + 1 atoms, set by the caller
        return MuZeroRNNModel.from_config(model_cfg, generator)

    # ------------------------------------------------------------ inference
    def _root_embedding(self, out0) -> Any:
        return dict(latent=out0.latent_state, history=out0.history)

    def _recurrent_fn(self, model: nn.Module, action: torch.Tensor, emb: Any) -> RecurrentOutput:
        out = model.recurrent_inference(emb["latent"], emb["history"], action)
        return RecurrentOutput(
            reward=inverse_scalar_transform(out.reward_logits, self.reward_support),
            value=inverse_scalar_transform(out.value_logits, self.value_support),
            prior_logits=out.policy_logits,
            embedding=dict(latent=out.latent_state, history=out.history),
        )

    # ---------------------------------------------------------------- learn
    def _sample_losses(self, model: nn.Module, batch: TrainBatch):
        """Per-sample loss vector before importance weighting and reduction:
        ``(loss (B,), logs, value_priority (B,))`` (the JAX ``_loss_fn``,
        muzero_rnn_full_obs.py:69-133)."""
        cfg = self.cfg
        K = self.num_unroll_steps
        tv_cat = phi_transform(self.value_support, scalar_transform(batch.target_value))
        tr_cat = phi_transform(self.reward_support, scalar_transform(batch.target_reward))

        out0 = model.initial_inference(batch.obs[:, 0])
        value_loss = cross_entropy_loss(out0.value_logits, tv_cat[:, 0])
        policy_loss = cross_entropy_loss(out0.policy_logits, batch.target_policy[:, 0])
        prob = torch.softmax(out0.policy_logits, dim=-1)
        entropy = -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-9)), dim=-1)
        policy_entropy_loss = -entropy
        pred_value0 = inverse_scalar_transform(out0.value_logits.detach(), self.value_support)
        value_priority = torch.abs(pred_value0 - batch.target_value[:, 0])

        latent, history = out0.latent_state, out0.history
        reward_loss = torch.zeros_like(value_loss)
        consistency_loss = torch.zeros_like(value_loss)
        for k in range(K):
            rec = model.recurrent_inference(latent, history, batch.actions[:, k])
            latent, history = rec.latent_state, rec.history
            if cfg.ssl_loss_weight > 0:
                proj_dyn = model.project(latent, with_grad=True)
                with torch.no_grad():
                    repr_k = model.representation(batch.obs[:, k + 1])
                    proj_obs = model.project(repr_k, with_grad=False)
                consistency_loss = consistency_loss + negative_cosine_similarity(
                    proj_dyn, proj_obs
                ) * batch.mask[:, k]
            policy_loss = policy_loss + cross_entropy_loss(
                rec.policy_logits, batch.target_policy[:, k + 1]
            )
            prob = torch.softmax(rec.policy_logits, dim=-1)
            entropy = -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-9)), dim=-1)
            policy_entropy_loss = policy_entropy_loss - entropy
            value_loss = value_loss + cross_entropy_loss(rec.value_logits, tv_cat[:, k + 1])
            reward_loss = reward_loss + cross_entropy_loss(rec.reward_logits, tr_cat[:, k])

        loss = (
            cfg.ssl_loss_weight * consistency_loss
            + cfg.policy_loss_weight * policy_loss
            + cfg.value_loss_weight * value_loss
            + cfg.reward_loss_weight * reward_loss
            + cfg.policy_entropy_weight * policy_entropy_loss
        )
        logs = dict(
            policy_loss=policy_loss.mean(),
            value_loss=value_loss.mean(),
            reward_loss=reward_loss.mean(),
            consistency_loss=consistency_loss.mean(),
            policy_entropy=entropy.mean(),
            predicted_value=pred_value0.mean(),
            target_value=batch.target_value[:, 0].mean(),
        )
        return loss, {k: v.detach() for k, v in logs.items()}, value_priority
