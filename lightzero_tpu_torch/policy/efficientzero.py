"""EfficientZero policy (``lightzero_tpu/policy/efficientzero.py``).

The model predicts a value prefix, the discounted reward sum since the last
reset of its LSTM, in place of MuZero's per-step reward. The search is the
pUCT search unchanged: its embedding is the dict ``latent, c, h, vp_accum,
depth``, and ``_recurrent_fn`` turns the value prefix into a reward,
``reward = vp - vp_accum``, and zeroes ``c``, ``h`` and ``vp_accum`` after
the model call at every depth that is a multiple of ``lstm_horizon_len``.
So collection, evaluation and reanalyze run the pUCT descent kernel at this
model's shapes.

The learn step unrolls the model ``num_unroll_steps`` steps with
cross-entropies on value, policy and value prefix (against the reward sum
within the horizon, reset after unroll step k+1 where k+1 is a multiple of
the horizon), the SSL consistency loss and the policy-entropy term.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.models.efficientzero import EfficientZeroModel
from lightzero_tpu_torch.ops import (
    cross_entropy_loss,
    inverse_scalar_transform,
    phi_transform,
    scalar_transform,
)
from lightzero_tpu_torch.policy.muzero import MuZeroPolicy, TrainBatch, negative_cosine_similarity
from lightzero_tpu_torch.search.types import RecurrentOutput


class EfficientZeroPolicy(MuZeroPolicy):
    # its JAX policy replaces MuZero's loss and has no HarmonyDream term
    harmony_loss = False

    @staticmethod
    def default_config() -> Config:
        cfg = MuZeroPolicy.default_config()
        cfg.type = "efficientzero"
        cfg.lstm_horizon_len = 5
        cfg.model.lstm_hidden_size = 512
        cfg.model.self_supervised_learning_loss = True
        cfg.ssl_loss_weight = 2.0
        return cfg

    def __init__(self, cfg=None, model=None, device=None, seed: int = 0):
        super().__init__(cfg, model=model, device=device, seed=seed)
        self.lstm_horizon_len = int(self.cfg.get("lstm_horizon_len", 5))

    def _build_model(self, model_cfg: Config, generator: torch.Generator) -> nn.Module:
        # both supports are 2 * support_scale + 1 atoms, set by the caller
        return EfficientZeroModel.from_config(model_cfg, generator)

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

    def _recurrent_fn(self, model: nn.Module, action: torch.Tensor, emb: Any) -> RecurrentOutput:
        out = model.recurrent_inference(emb["latent"], (emb["c"], emb["h"]), action)
        vp = inverse_scalar_transform(out.value_prefix_logits, self.reward_support)
        value = inverse_scalar_transform(out.value_logits, self.value_support)
        reward = vp - emb["vp_accum"]
        depth = emb["depth"] + 1
        # the horizon reset (mcts_ctree.py:853-861: search_len % horizon == 0)
        reset = (depth % self.lstm_horizon_len) == 0
        c, h = out.reward_hidden
        keep = 1.0 - reset[:, None].to(c.dtype)
        new_emb = dict(
            latent=out.latent_state,
            c=c * keep,
            h=h * keep,
            vp_accum=torch.where(reset, 0.0, vp),
            depth=depth,
        )
        return RecurrentOutput(
            reward=reward, value=value, prior_logits=out.policy_logits, embedding=new_emb
        )

    # ---------------------------------------------------------------- learn
    def _sample_losses(self, model: nn.Module, batch: TrainBatch):
        """Per-sample loss vector before importance weighting and reduction:
        ``(loss (B,), logs, value_priority (B,))`` (the JAX ``_loss_fn``,
        efficientzero.py:106-190)."""
        cfg = self.cfg
        K = self.num_unroll_steps
        tv_cat = phi_transform(self.value_support, scalar_transform(batch.target_value))

        out0 = model.initial_inference(batch.obs[:, 0])
        value_loss = cross_entropy_loss(out0.value_logits, tv_cat[:, 0])
        policy_loss = cross_entropy_loss(out0.policy_logits, batch.target_policy[:, 0])
        prob = torch.softmax(out0.policy_logits, dim=-1)
        entropy = -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-9)), dim=-1)
        policy_entropy_loss = -entropy
        pred_value0 = inverse_scalar_transform(out0.value_logits.detach(), self.value_support)
        value_priority = torch.abs(pred_value0 - batch.target_value[:, 0])

        latent = out0.latent_state
        reward_hidden = out0.reward_hidden
        vp_target = torch.zeros_like(batch.target_reward[:, 0])
        prefix_loss = torch.zeros_like(value_loss)
        consistency_loss = torch.zeros_like(value_loss)
        ssl = cfg.ssl_loss_weight > 0

        for k in range(K):
            out = model.recurrent_inference(latent, reward_hidden, batch.actions[:, k])
            latent = out.latent_state
            reward_hidden = out.reward_hidden
            if ssl:
                proj_dyn = model.project(latent, with_grad=True)
                with torch.no_grad():
                    repr_k = model.representation(batch.obs[:, k + 1])
                    proj_obs = model.project(repr_k, with_grad=False)
                consistency_loss = consistency_loss + negative_cosine_similarity(
                    proj_dyn, proj_obs
                ) * batch.mask[:, k]
            policy_loss = policy_loss + cross_entropy_loss(
                out.policy_logits, batch.target_policy[:, k + 1]
            )
            prob = torch.softmax(out.policy_logits, dim=-1)
            entropy = -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-9)), dim=-1)
            policy_entropy_loss = policy_entropy_loss - entropy
            value_loss = value_loss + cross_entropy_loss(out.value_logits, tv_cat[:, k + 1])
            # the value-prefix target: the reward sum within the horizon
            vp_target = vp_target + batch.target_reward[:, k]
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
            # the last unroll step's entropy, as in the JAX policy
            policy_entropy=entropy.mean(),
            predicted_value=pred_value0.mean(),
            target_value=batch.target_value[:, 0].mean(),
        )
        return loss, {k: v.detach() for k, v in logs.items()}, value_priority
