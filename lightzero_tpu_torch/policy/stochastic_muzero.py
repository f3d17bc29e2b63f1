"""Stochastic MuZero policy (``lightzero_tpu/policy/stochastic_muzero.py``).

The search alternates decision and chance (afterstate) nodes: decision
children are picked by pUCT, chance children are sampled from the predicted
distribution over chance outcomes, through the pUCT search's generic descent
(``SearchConfig.stochastic``). The tree is ``max(A, C)`` wide: decision
rows hold the A actions, chance rows the C outcomes, and the rest of a row
is illegal. ``_recurrent_fn`` runs both model branches on every leaf and
picks per lane by the parent's kind, as the JAX policy does.

The learn step unrolls decision and chance steps with cross-entropies on
value, reward and policy, the afterstate value and the afterstate's chance
distribution (against the env's true chance codes with
``use_ture_chance_label_in_chance_encoder``, else against the encoder's own
code), and the commitment MSE of the chance encoder's logits. It has no SSL
term. The JAX semantics are kept as they stand, the discount on both the
decision and the chance edge of the search included.

Refused with ``NotImplementedError``: reanalyze (``reanalyze_ratio > 0``).
The JAX policy does not override ``_forward_reanalyze``, whose A-wide tree
meets this policy's ``tree_width``-wide recurrent outputs and fails with a
broadcasting ``ValueError`` (ROADMAP queue 3); the 2048 configs leave
``reanalyze_ratio`` at 0.

Refused with ``ValueError``: a conv model. The model has a conv branch, but
the JAX policy flattens every observation before the representation network
(``_flat``, ``lightzero_tpu/policy/stochastic_muzero.py:76-81``), so its conv
model fails at the first inference with a ``ScopeParamShapeError`` (ROADMAP
queue 3); the port keeps the policy's semantics and refuses up front.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch import nn

from lightzero_tpu_torch.config import Config, deep_merge
from lightzero_tpu_torch.models.stochastic_muzero import StochasticMuZeroModel
from lightzero_tpu_torch.ops import (
    cross_entropy_loss,
    inverse_scalar_transform,
    phi_transform,
    scalar_transform,
)
from lightzero_tpu_torch.ops.action import sample_from_visit_counts
from lightzero_tpu_torch.policy.muzero import MuZeroPolicy, TrainBatch
from lightzero_tpu_torch.search.puct import batch_puct_search
from lightzero_tpu_torch.search.types import RecurrentOutput, RootOutput
from lightzero_tpu_torch.utils import profiling

_CONV_REFUSED = (
    "the Stochastic MuZero policy flattens observations before its model, as the JAX "
    "policy does (policy/stochastic_muzero.py:76-81), so a conv model cannot read them; "
    "the JAX policy fails the same way (ROADMAP queue 3)"
)
_REANALYZE_REFUSED = (
    "reanalyze is not ported for Stochastic MuZero: the JAX policy's reanalyze search "
    "fails there (ROADMAP queue 3), and the 2048 configs leave reanalyze_ratio at 0"
)


def _entropy(logits: torch.Tensor) -> torch.Tensor:
    prob = torch.softmax(logits, dim=-1)
    return -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-9)), dim=-1)


class StochasticMuZeroPolicy(MuZeroPolicy):
    # its JAX policy replaces MuZero's loss and has no HarmonyDream term
    harmony_loss = False
    # the model reads each observation flattened (``_flat``)
    flattens_observations = True

    @staticmethod
    def default_config() -> Config:
        cfg = MuZeroPolicy.default_config()
        cfg.type = "stochastic_muzero"
        cfg.model.chance_space_size = 32
        cfg.use_ture_chance_label_in_chance_encoder = True
        cfg.afterstate_policy_loss_weight = 1.0
        cfg.afterstate_value_loss_weight = 0.25
        cfg.commitment_loss_weight = 1.0
        return cfg

    def __init__(self, cfg=None, model=None, device=None, seed: int = 0):
        model_type = deep_merge(self.default_config(), cfg or {}).model.model_type
        if model_type != "mlp" or getattr(model, "model_type", "mlp") != "mlp":
            raise ValueError(_CONV_REFUSED)
        super().__init__(cfg, model=model, device=device, seed=seed)
        if float(self.cfg.get("reanalyze_ratio", 0.0)) > 0:
            raise NotImplementedError(_REANALYZE_REFUSED)
        self.action_space = int(self.cfg.model.action_space_size)
        self.chance_space = int(self.cfg.model.get("chance_space_size", 32))
        self.tree_width = max(self.action_space, self.chance_space)
        # a single-player search whatever env_type says, as in the JAX policy
        self.search_cfg = dataclasses.replace(self.search_cfg, players=1, stochastic=True)

    def _build_model(self, model_cfg: Config, generator: torch.Generator) -> nn.Module:
        return StochasticMuZeroModel.from_config(model_cfg, generator)

    # ------------------------------------------------------------ inference
    @staticmethod
    def _flat(obs: torch.Tensor) -> torch.Tensor:
        return obs.reshape(obs.shape[0], -1)

    def _root_embedding(self, out0) -> Any:
        latent = out0.latent_state
        return dict(latent=latent,
                    is_chance=torch.zeros((latent.shape[0],), dtype=torch.bool, device=latent.device))

    def _pad_width(self, x: torch.Tensor, fill) -> torch.Tensor:
        """(B, A or C) -> (B, tree_width), padded with ``fill``."""
        pad = self.tree_width - x.shape[-1]
        if pad == 0:
            return x
        return torch.cat([x, torch.full((x.shape[0], pad), fill, dtype=x.dtype, device=x.device)],
                         dim=-1)

    def _recurrent_fn(self, model: nn.Module, action: torch.Tensor, emb: Any) -> RecurrentOutput:
        """A decision parent gives an afterstate (chance) leaf, a chance parent
        a decision leaf: both branches run on every lane, each with the action
        clamped to its own width, and the parent's kind picks."""
        latent = emb["latent"]
        pc = emb["is_chance"]
        as_out = model.recurrent_inference(latent, torch.clamp(action, max=self.action_space - 1),
                                           False)
        dec_out = model.recurrent_inference(latent, torch.clamp(action, max=self.chance_space - 1),
                                            True)

        def pick(a, b):
            return torch.where(pc.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

        width = torch.arange(self.tree_width, device=latent.device)
        legal = torch.where(pc[:, None], width < self.action_space, width < self.chance_space)
        return RecurrentOutput(
            reward=inverse_scalar_transform(pick(dec_out.reward_logits, as_out.reward_logits),
                                            self.reward_support),
            value=inverse_scalar_transform(pick(dec_out.value_logits, as_out.value_logits),
                                           self.value_support),
            prior_logits=pick(self._pad_width(dec_out.policy_logits, -1e9),
                              self._pad_width(as_out.policy_logits, -1e9)),
            embedding=dict(latent=pick(dec_out.latent_state, as_out.latent_state), is_chance=~pc),
            legal_mask=legal,
            is_chance=~pc,
        )

    @torch.no_grad()
    def _forward_collect(
        self,
        obs: torch.Tensor,
        legal_mask: torch.Tensor,
        to_play: torch.Tensor,
        temperature: float,
        epsilon: float,
        deterministic: bool = False,
        noise: Optional[torch.Tensor] = None,
        chance_noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """The search over a ``tree_width``-wide root (the prior and the legal
        mask padded), the visit counts cut back to the A actions. ``noise``
        (B, tree_width), the root's Dirichlet draw, and ``chance_noise``
        (num_simulations, N + 1, B, tree_width), the chance nodes' Gumbel
        draws, replace the search's own draws (for tests)."""
        profiling.new_request()
        g = self.generator
        obs = obs.to(self.device, torch.float32)
        legal_mask = legal_mask.to(self.device)
        out0 = self.model.initial_inference(self._flat(obs))
        pred_value = inverse_scalar_transform(out0.value_logits, self.value_support)
        root = RootOutput(
            prior_logits=self._pad_width(out0.policy_logits, -1e9),
            value=pred_value,
            embedding=self._root_embedding(out0),
        )
        search_out = batch_puct_search(
            root,
            functools.partial(self._recurrent_fn, self.model),
            self.search_cfg,
            self._pad_width(legal_mask, False),
            to_play=to_play.to(self.device),
            with_noise=not deterministic,
            noise=noise,
            generator=g,
            device=self.device,
            chance_noise=chance_noise,
        )
        counts = search_out.visit_counts[:, : self.action_space]
        actions, dist_entropy = sample_from_visit_counts(
            counts, temperature, deterministic=deterministic, generator=g
        )
        if not deterministic and epsilon > 0:
            B = legal_mask.shape[0]
            rand_action = torch.multinomial(legal_mask.to(torch.float32), 1, generator=g).squeeze(-1)
            explore = torch.rand(B, generator=g, device=self.device) < epsilon
            actions = torch.where(explore, rand_action, actions)
        return dict(
            action=actions,
            visit_counts=counts,
            searched_value=search_out.root_value,
            predicted_value=pred_value,
            policy_logits=out0.policy_logits,
            distribution_entropy=dist_entropy,
        )

    def forward_reanalyze(self, *args, **kwargs):
        raise NotImplementedError(_REANALYZE_REFUSED)

    @torch.no_grad()
    def _bootstrap_value_fn(self, target_model: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        out = target_model.initial_inference(self._flat(obs))
        return inverse_scalar_transform(out.value_logits, self.value_support)

    # ---------------------------------------------------------------- learn
    def _sample_losses(self, model: nn.Module, batch: TrainBatch):
        """Per-sample loss vector before importance weighting and reduction:
        ``(loss (B,), logs, value_priority (B,))`` (the JAX ``_loss_fn``,
        stochastic_muzero.py:177-270)."""
        cfg = self.cfg
        K = self.num_unroll_steps
        A, C = self.action_space, self.chance_space
        use_true = bool(cfg.get("use_ture_chance_label_in_chance_encoder", True))
        tv_cat = phi_transform(self.value_support, scalar_transform(batch.target_value))
        tr_cat = phi_transform(self.reward_support, scalar_transform(batch.target_reward))

        out0 = model.initial_inference(self._flat(batch.obs[:, 0]))
        value_loss = cross_entropy_loss(out0.value_logits, tv_cat[:, 0])
        policy_loss = cross_entropy_loss(out0.policy_logits, batch.target_policy[:, 0, :A])
        entropy = _entropy(out0.policy_logits)
        policy_entropy_loss = -entropy
        pred_value0 = inverse_scalar_transform(out0.value_logits.detach(), self.value_support)
        value_priority = torch.abs(pred_value0 - batch.target_value[:, 0])

        latent = out0.latent_state
        zeros = torch.zeros_like(value_loss)
        reward_loss = afterstate_policy_loss = afterstate_value_loss = commitment_loss = zeros
        for k in range(K):
            # decision step -> afterstate
            as_out = model.recurrent_inference(latent, batch.actions[:, k], False)
            # the chance code: the env's true label, or the encoder's code of
            # the two consecutive observations
            obs_pair = torch.cat([self._flat(batch.obs[:, k]), self._flat(batch.obs[:, k + 1])],
                                 dim=-1)
            enc_logits, enc_onehot = model.chance_encode(obs_pair)
            if use_true and batch.chance is not None:
                chance_code = batch.chance[:, k].long()
                chance_onehot = nn.functional.one_hot(chance_code, C).to(enc_logits.dtype)
            else:
                chance_code = torch.argmax(enc_logits, dim=-1)
                chance_onehot = enc_onehot
            target_code = nn.functional.one_hot(chance_code, C).to(enc_logits.dtype)
            commitment_loss = commitment_loss + torch.mean((enc_logits - target_code) ** 2, dim=-1)
            # chance step -> next latent
            dec_out = model.recurrent_inference(as_out.latent_state, chance_code, True)
            latent = dec_out.latent_state

            afterstate_policy_loss = afterstate_policy_loss + cross_entropy_loss(
                as_out.policy_logits, chance_onehot.detach())
            afterstate_value_loss = afterstate_value_loss + cross_entropy_loss(
                as_out.value_logits, tv_cat[:, k])
            value_loss = value_loss + cross_entropy_loss(dec_out.value_logits, tv_cat[:, k + 1])
            reward_loss = reward_loss + cross_entropy_loss(dec_out.reward_logits, tr_cat[:, k])
            policy_loss = policy_loss + cross_entropy_loss(
                dec_out.policy_logits, batch.target_policy[:, k + 1, :A])
            entropy = _entropy(dec_out.policy_logits)
            policy_entropy_loss = policy_entropy_loss - entropy

        loss = (
            cfg.policy_loss_weight * policy_loss
            + cfg.value_loss_weight * value_loss
            + cfg.reward_loss_weight * reward_loss
            + cfg.afterstate_policy_loss_weight * afterstate_policy_loss
            + cfg.afterstate_value_loss_weight * afterstate_value_loss
            + cfg.commitment_loss_weight * commitment_loss
            + cfg.policy_entropy_weight * policy_entropy_loss
        )
        logs = dict(
            policy_loss=policy_loss.mean(),
            value_loss=value_loss.mean(),
            reward_loss=reward_loss.mean(),
            afterstate_policy_loss=afterstate_policy_loss.mean(),
            afterstate_value_loss=afterstate_value_loss.mean(),
            commitment_loss=commitment_loss.mean(),
            # the last unroll step's entropy, as in the JAX policy
            policy_entropy=entropy.mean(),
            predicted_value=pred_value0.mean(),
            target_value=batch.target_value[:, 0].mean(),
        )
        return loss, {k: v.detach() for k, v in logs.items()}, value_priority
