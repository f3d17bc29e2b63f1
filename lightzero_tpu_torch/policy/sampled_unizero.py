"""Sampled UniZero policy (``lightzero_tpu/policy/sampled_unizero.py``): the
UniZero world model and KV-cache search with K sampled actions per node, as
Sampled MuZero samples them (``policy/sampled_muzero.py``): tanh-Gaussian
draws in a continuous action space, K distinct actions by Gumbel-top-K in a
discrete one. The node embedding is ``{"cache": KVCache, "sampled_actions":
(B, K, D) or (B, K)}``, so the search runs through the descent kernel with
A = K.

The learn step is UniZero's (accumulation, the non-finite guard, the clamp
and clips, the target copy) over a ``SampledTrainBatch``; its loss is the
value and reward cross-entropies, the next-latent loss and, at every obs
position, the visit-weighted log-density of the stored root candidates
(normalised over them with ``normalize_prob_of_sampled_actions``) and the
entropy term at ``policy_entropy_weight``. The adaptive entropy, the
reconstruction loss and the drift correction are not part of it, as in the
JAX policy.

Randomness: the candidates are drawn from the policy's generator, the root's
and one table per simulation; ``_forward_collect_stateful`` takes the root's
draws and a (num_simulations, ...) stack of the simulations' in their place
(for tests, which rebuild JAX's from its keys).

Refused with ``NotImplementedError``: reanalyze (``reanalyze_ratio > 0``):
the JAX policy inherits UniZero's reanalyze, whose root prior is the logits
head over actions where the sampled search has K slots, and the Pendulum
configs leave ``reanalyze_ratio`` at 0.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.models.unizero_world_model.transformer import KVCache
from lightzero_tpu_torch.ops import (
    cross_entropy_loss,
    inverse_scalar_transform,
    phi_transform,
    scalar_transform,
)
from lightzero_tpu_torch.ops.action import sample_from_visit_counts
from lightzero_tpu_torch.policy.sampled_muzero import (
    SampledTrainBatch,
    gaussian_tanh_logp,
    sample_candidates,
    sampled_search_prior,
)
from lightzero_tpu_torch.policy.unizero import UniZeroPolicy, predict_latent_loss
from lightzero_tpu_torch.search.puct import batch_puct_search
from lightzero_tpu_torch.search.types import RecurrentOutput, RootOutput
from lightzero_tpu_torch.utils import profiling

_REANALYZE_REFUSED = (
    "reanalyze is not ported for Sampled UniZero: the JAX policy's reanalyze searches "
    "UniZero's logits prior over a tree of K sampled slots, and the Pendulum configs leave "
    "reanalyze_ratio at 0"
)


class SampledUniZeroPolicy(UniZeroPolicy):
    @staticmethod
    def default_config() -> Config:
        cfg = UniZeroPolicy.default_config()
        cfg.type = "sampled_unizero"
        cfg.num_of_sampled_actions = 20
        cfg.normalize_prob_of_sampled_actions = True
        cfg.model.continuous_action_space = True
        cfg.policy_entropy_weight = 5e-3
        return cfg

    def __init__(self, cfg=None, model=None, device=None, seed: int = 0):
        super().__init__(cfg, model=model, device=device, seed=seed)
        if float(self.cfg.get("reanalyze_ratio", 0.0)) > 0:
            raise NotImplementedError(_REANALYZE_REFUSED)
        self.K = int(self.cfg.get("num_of_sampled_actions", 20))
        self.discrete = not bool(self.cfg.model.get("continuous_action_space", True))

    # ------------------------------------------------------------ inference
    def _sample_candidates(self, out: Dict[str, torch.Tensor],
                           draws: Optional[torch.Tensor] = None,
                           legal_mask: Optional[torch.Tensor] = None):
        """K candidates and their log-weights from the obs heads; ``draws``
        (standard normals (B, K, D), or Gumbels (B, A) when discrete) default
        to the policy generator's."""
        if self.discrete:
            return sample_candidates(self.K, self.generator, logits=out["policy_logits"],
                                     draws=draws, legal_mask=legal_mask)
        return sample_candidates(self.K, self.generator, mu=out["mu"], sigma=out["sigma"],
                                 draws=draws)

    def _recurrent_fn(self, model: nn.Module, draws: Optional[Iterator[torch.Tensor]],
                      slot: torch.Tensor, emb) -> RecurrentOutput:
        action = emb["sampled_actions"][torch.arange(slot.shape[0], device=slot.device), slot]
        tid = self._task_ids(slot.shape[0])
        a_out, cache = model.infer_action_step(emb["cache"], action, tid)
        o_out, cache = model.infer_obs_step(cache, a_out["obs_pred"], tid)
        new_actions, logp = self._sample_candidates(o_out, None if draws is None else next(draws))
        return RecurrentOutput(
            reward=inverse_scalar_transform(a_out["reward_logits"], self.reward_support),
            value=inverse_scalar_transform(o_out["value_logits"], self.value_support),
            prior_logits=sampled_search_prior(self.cfg, logp),
            embedding=dict(cache=cache, sampled_actions=new_actions),
        )

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
        root_draws: Optional[torch.Tensor] = None,
        sim_draws: Optional[torch.Tensor] = None,
    ) -> Tuple[Dict[str, torch.Tensor], KVCache]:
        """Search over the root's K candidates (all slots legal) from the
        context with the observation appended, act with the chosen slot's
        candidate, and append it to the context. ``epsilon`` is unused, as in
        the JAX policy. ``noise`` (B, K), ``root_draws`` and ``sim_draws``
        (num_simulations, ...) replace the policy's draws (for tests)."""
        profiling.new_request()
        dev = self.device
        model = self.model
        obs = obs.to(dev, torch.float32)
        tid = self._task_ids(obs.shape[0])
        o_out, cache = model.infer_obs_step(collect_state, model.encode_obs(obs), tid)
        pred_value = inverse_scalar_transform(o_out["value_logits"], self.value_support)
        root_actions, root_logp = self._sample_candidates(
            o_out, None if root_draws is None else root_draws.to(dev),
            legal_mask=legal_mask.to(dev) if self.discrete else None)
        root = RootOutput(prior_logits=sampled_search_prior(self.cfg, root_logp), value=pred_value,
                          embedding=dict(cache=cache, sampled_actions=root_actions))
        B = obs.shape[0]
        draws = None if sim_draws is None else iter(sim_draws.to(dev))
        search_out = batch_puct_search(
            root,
            lambda slot, emb: self._recurrent_fn(model, draws, slot, emb),
            self.search_cfg,
            torch.ones((B, self.K), dtype=torch.bool, device=dev),
            to_play=to_play.to(dev),
            with_noise=not deterministic,
            noise=noise,
            generator=self.generator,
            device=dev,
        )
        slot, dist_entropy = sample_from_visit_counts(
            search_out.visit_counts, temperature, deterministic=deterministic,
            generator=self.generator)
        action = root_actions[torch.arange(B, device=dev), slot]
        _, new_state = model.infer_action_step(cache, action, tid)
        out = dict(
            action=action,
            chosen_slot=slot,
            visit_counts=search_out.visit_counts,
            root_sampled_actions=root_actions,
            searched_value=search_out.root_value,
            predicted_value=pred_value,
            distribution_entropy=dist_entropy,
        )
        return out, new_state

    def forward_reanalyze(self, *args, **kwargs):
        raise NotImplementedError(_REANALYZE_REFUSED)

    # ---------------------------------------------------------------- learn
    def _sample_losses(self, model: nn.Module, batch: SampledTrainBatch,
                       task_id: Optional[torch.Tensor] = None, train_iter: int = 0):
        """(loss (B,), extra 0, logs, value_priority (B,)) of a
        ``SampledTrainBatch`` (sampled_unizero.py:136-202); ``task_id`` (B,)
        conditions the world model's tokens."""
        cfg = self.cfg
        base, sampled = batch.base, batch.sampled_actions  # (B, K+1, Ks[, D])
        tv_cat = phi_transform(self.value_support, scalar_transform(base.target_value))
        tr_cat = phi_transform(self.reward_support, scalar_transform(base.target_reward))
        out = model.train_forward(base.obs, base.actions, task_id)
        value_loss = cross_entropy_loss(out["value_logits"], tv_cat).sum(-1)
        reward_loss = cross_entropy_loss(out["reward_logits"], tr_cat).sum(-1)
        obs_loss = predict_latent_loss(out["obs_pred"], out["obs_embeddings"][:, 1:].detach(),
                                       base.mask, str(cfg.get("predict_latent_loss_type", "mse")))
        if self.discrete:
            acts = sampled.long()
            if acts.dim() == 4:
                acts = acts[..., 0]
            logp_all = torch.log_softmax(out["policy_logits"], dim=-1)
            logp = torch.gather(logp_all, -1, acts)  # (B, K+1, Ks)
            entropy = -torch.sum(torch.softmax(out["policy_logits"], dim=-1) * logp_all,
                                 dim=-1).mean(-1)
        else:
            mu, sigma = out["mu"], out["sigma"]
            logp = gaussian_tanh_logp(sampled, mu[:, :, None, :], sigma[:, :, None, :])
            entropy = torch.sum(0.5 * torch.log(2 * math.pi * math.e * sigma ** 2),
                                dim=-1).mean(-1)
        if bool(cfg.get("normalize_prob_of_sampled_actions", True)):
            logp = logp - torch.logsumexp(logp, dim=-1, keepdim=True).detach()
        policy_loss = -torch.sum(base.target_policy * logp, dim=-1).sum(-1)
        pred_value0 = inverse_scalar_transform(out["value_logits"][:, 0].detach(),
                                               self.value_support)
        value_priority = torch.abs(pred_value0 - base.target_value[:, 0])
        loss = (cfg.policy_loss_weight * policy_loss + cfg.value_loss_weight * value_loss
                + cfg.reward_loss_weight * reward_loss + cfg.obs_loss_weight * obs_loss
                + cfg.policy_entropy_weight * (-entropy))
        logs = dict(
            policy_loss=policy_loss.mean(),
            value_loss=value_loss.mean(),
            reward_loss=reward_loss.mean(),
            obs_loss=obs_loss.mean(),
            policy_entropy=entropy.mean(),
            predicted_value=pred_value0.mean(),
            target_value=base.target_value[:, 0].mean(),
        )
        return (loss, torch.zeros((), device=loss.device),
                {k: v.detach() for k, v in logs.items()}, value_priority)
