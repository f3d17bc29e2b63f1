"""Sampled MuZero policy (``lightzero_tpu/policy/sampled_muzero.py``).

At every node K actions are sampled from the policy head: tanh-squashed
Gaussian draws in a continuous action space, K distinct actions by
Gumbel-top-K in a discrete one. The K candidates are the tree's action
slots, and their vectors (or indices) travel in the search embedding
``{latent, sampled_actions}``; the slots' prior is ``sampled_search_prior``
of the candidates' log-weights (uniform by default). So the search is the
pUCT search unchanged, through the descent kernel with A = K.

The learn step's policy loss is -Σ_j π̂(j) log q(a_j | s) over the root's
stored candidates, π̂ the normalised root visit counts, with the optional
normalisation of the log-densities over the candidates
(``normalize_prob_of_sampled_actions``), plus the entropy term, the value
and reward cross-entropies and the SSL consistency loss.

Randomness: the candidates are drawn from the policy's generator, the root's
and one table per simulation. ``_forward_collect`` takes the root's draws
and a (num_simulations, ...) stack of the simulations' draws in their place
(for tests, which rebuild JAX's from its keys): standard normals
(B, K, D), or Gumbels (B, A) in a discrete action space.

Refused with ``NotImplementedError``: reanalyze (``reanalyze_ratio > 0``).
The JAX policy does not override ``_forward_reanalyze``, which reads
``policy_logits`` off the dict that this model returns and fails with an
``AttributeError`` (ROADMAP queue 3); the Pendulum configs leave
``reanalyze_ratio`` at 0.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Iterator, NamedTuple, Optional

import torch
from torch import nn

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.models.sampled_muzero import SampledMuZeroModel
from lightzero_tpu_torch.ops import (
    cross_entropy_loss,
    inverse_scalar_transform,
    phi_transform,
    scalar_transform,
)
from lightzero_tpu_torch.ops.action import sample_from_visit_counts
from lightzero_tpu_torch.policy.muzero import MuZeroPolicy, TrainBatch, negative_cosine_similarity
from lightzero_tpu_torch.search.puct import batch_puct_search
from lightzero_tpu_torch.search.types import RecurrentOutput, RootOutput
from lightzero_tpu_torch.utils import profiling

_LOG_EPS = 1e-6
_REANALYZE_REFUSED = (
    "reanalyze is not ported for the sampled policies: the JAX policy's reanalyze fails "
    "on the sampled model's outputs (ROADMAP queue 3), and the Pendulum configs leave "
    "reanalyze_ratio at 0"
)


class SampledTrainBatch(NamedTuple):
    """A ``TrainBatch`` and the root candidates of its K+1 positions:
    (B, K+1, Ks, D) floats, or (B, K+1, Ks) indices stored as floats."""

    base: TrainBatch
    sampled_actions: torch.Tensor


def _normal_logp(x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return torch.sum(
        -0.5 * ((x - mu) / sigma) ** 2 - torch.log(sigma) - 0.5 * math.log(2 * math.pi), dim=-1
    )


def gaussian_tanh_sample(mu: torch.Tensor, sigma: torch.Tensor, normals: torch.Tensor,
                         prior_space: str = "pre_tanh"):
    """K tanh-squashed actions from standard normals (B, K, D):
    (actions (B, K, D), log-weights (B, K)). The log-weights are the
    Gaussian density at the pre-squash point ('pre_tanh'), or the
    action-space density with the tanh Jacobian ('squashed')."""
    x = mu[:, None, :] + sigma[:, None, :] * normals
    a = torch.tanh(x)
    logp = _normal_logp(x, mu[:, None, :], sigma[:, None, :])
    if prior_space == "squashed":
        logp = logp - torch.sum(torch.log(1.0 - a**2 + _LOG_EPS), dim=-1)
    return a, logp


def sample_discrete_actions(logits: torch.Tensor, num_samples: int, gumbel: torch.Tensor,
                            legal_mask: Optional[torch.Tensor] = None):
    """K distinct actions by Gumbel-top-K from standard Gumbels (B, A):
    (actions (B, K) int64, log softmax of the (masked) logits at them)."""
    if legal_mask is not None:
        logits = torch.where(legal_mask, logits, -torch.inf)
    actions = torch.topk(logits + gumbel, num_samples, dim=-1).indices
    logp_all = torch.log_softmax(torch.where(torch.isfinite(logits), logits, -1e9), dim=-1)
    return actions, torch.gather(logp_all, -1, actions)


def sample_candidates(K: int, generator: torch.Generator, logits: Optional[torch.Tensor] = None,
                      mu: Optional[torch.Tensor] = None, sigma: Optional[torch.Tensor] = None,
                      draws: Optional[torch.Tensor] = None,
                      legal_mask: Optional[torch.Tensor] = None):
    """K candidates and their log-weights: Gumbel-top-K of ``logits`` when
    given (discrete), else tanh-Gaussian draws from (``mu``, ``sigma``).
    ``draws`` (Gumbels (B, A), or standard normals (B, K, D)) default to
    ``generator``'s."""
    if logits is not None:
        if draws is None:
            u = torch.rand(logits.shape, generator=generator, device=logits.device,
                           dtype=logits.dtype)
            draws = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
        return sample_discrete_actions(logits, K, draws, legal_mask=legal_mask)
    if draws is None:
        B, D = mu.shape
        draws = torch.randn((B, K, D), generator=generator, device=mu.device, dtype=mu.dtype)
    return gaussian_tanh_sample(mu, sigma, draws)


def sampled_search_prior(cfg: Config, logp: torch.Tensor) -> torch.Tensor:
    """The slots' prior logits: uniform (zeros) under ``sampled_node_prior``
    'uniform', the candidates' log-weights under 'density'."""
    if str(cfg.get("sampled_node_prior", "uniform")) == "uniform":
        return torch.zeros_like(logp)
    return logp


def gaussian_tanh_logp(actions: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """log q(a) of stored squashed actions a (..., D) under (mu, sigma)."""
    a = torch.clamp(actions, -1.0 + 1e-6, 1.0 - 1e-6)
    logp = _normal_logp(torch.atanh(a), mu, sigma)
    return logp - torch.sum(torch.log(1.0 - a**2 + _LOG_EPS), dim=-1)


def _gaussian_entropy(sigma: torch.Tensor) -> torch.Tensor:
    """The pre-squash Gaussian's entropy, summed over the action's dims."""
    return torch.sum(0.5 * torch.log(2 * math.pi * math.e * sigma**2), dim=-1)


class SampledMuZeroPolicy(MuZeroPolicy):
    # its JAX policy replaces MuZero's loss and has no HarmonyDream term
    harmony_loss = False

    @staticmethod
    def default_config() -> Config:
        cfg = MuZeroPolicy.default_config()
        cfg.type = "sampled_muzero"
        cfg.num_of_sampled_actions = 20
        cfg.normalize_prob_of_sampled_actions = False
        cfg.sampled_node_prior = "uniform"
        cfg.model.continuous_action_space = True
        cfg.model.self_supervised_learning_loss = True
        cfg.ssl_loss_weight = 2.0
        cfg.policy_entropy_weight = 5e-3
        return cfg

    def __init__(self, cfg=None, model=None, device=None, seed: int = 0):
        super().__init__(cfg, model=model, device=device, seed=seed)
        if float(self.cfg.get("reanalyze_ratio", 0.0)) > 0:
            raise NotImplementedError(_REANALYZE_REFUSED)
        self.K = int(self.cfg.get("num_of_sampled_actions", 20))
        self.discrete = not bool(self.cfg.model.get("continuous_action_space", True))

    def _build_model(self, model_cfg: Config, generator: torch.Generator) -> nn.Module:
        return SampledMuZeroModel.from_config(model_cfg, generator)

    # ------------------------------------------------------------ inference
    def _sample_candidates(self, out, draws: Optional[torch.Tensor] = None,
                           legal_mask: Optional[torch.Tensor] = None):
        """K candidates and their log-weights from a model output; ``draws``
        (standard normals (B, K, D), or Gumbels (B, A) when discrete) default
        to the policy generator's."""
        if self.discrete:
            return sample_candidates(self.K, self.generator, logits=out.policy_logits,
                                     draws=draws, legal_mask=legal_mask)
        return sample_candidates(self.K, self.generator, mu=out.mu, sigma=out.sigma, draws=draws)

    @staticmethod
    def _slot_actions(emb: Any, slot: torch.Tensor) -> torch.Tensor:
        """The action of each tree's chosen slot: (B, D) or (B,)."""
        return emb["sampled_actions"][torch.arange(slot.shape[0], device=slot.device), slot]

    def _recurrent_fn(self, model: nn.Module, draws: Optional[Iterator[torch.Tensor]],
                      slot: torch.Tensor, emb: Any) -> RecurrentOutput:
        out = model.recurrent_inference(emb["latent"], self._slot_actions(emb, slot))
        new_actions, logp = self._sample_candidates(out, None if draws is None else next(draws))
        return RecurrentOutput(
            reward=inverse_scalar_transform(out.reward_logits, self.reward_support),
            value=inverse_scalar_transform(out.value_logits, self.value_support),
            prior_logits=sampled_search_prior(self.cfg, logp),
            embedding=dict(latent=out.latent_state, sampled_actions=new_actions),
        )

    def _root_embedding(self, out0) -> Any:
        """The root's embedding without its candidates; variants extend it."""
        return dict(latent=out0.latent_state)

    def _collect_telemetry(self, out0, visit_counts: torch.Tensor, root_actions: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
        """Where the search's targets pull the Gaussian (continuous only):
        the visit-weighted mean candidate, and the mean of tanh(mu) and of
        sigma, each averaged over the action's dims."""
        if self.discrete:
            return {}
        vw = visit_counts.to(torch.float32)
        vw = vw / torch.clamp(vw.sum(dim=-1, keepdim=True), min=1.0)
        visit_mean_action = torch.einsum("bk,bkd->bd", vw, root_actions)
        return dict(visit_mean_action=visit_mean_action.mean(dim=-1),
                    collect_mu=torch.tanh(out0.mu).mean(dim=-1),
                    collect_sigma=out0.sigma.mean(dim=-1))

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
        root_draws: Optional[torch.Tensor] = None,
        sim_draws: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Search over the root's K candidates (all slots legal) and act with
        the chosen slot's candidate. ``epsilon`` is unused, as in the JAX
        policy. ``noise`` (B, K) replaces the root's Dirichlet draw,
        ``root_draws`` the root's candidate draws and ``sim_draws``
        (num_simulations, ...) those of each simulation (for tests)."""
        profiling.new_request()
        g, dev = self.generator, self.device
        obs = obs.to(dev, torch.float32)
        out0 = self.model.initial_inference(obs)
        B = obs.shape[0]
        root_actions, root_logp = self._sample_candidates(
            out0, None if root_draws is None else root_draws.to(dev),
            legal_mask=legal_mask.to(dev) if self.discrete else None,
        )
        pred_value = inverse_scalar_transform(out0.value_logits, self.value_support)
        root = RootOutput(
            prior_logits=sampled_search_prior(self.cfg, root_logp),
            value=pred_value,
            embedding=dict(self._root_embedding(out0), sampled_actions=root_actions),
        )
        draws = None if sim_draws is None else iter(sim_draws.to(dev))
        search_out = batch_puct_search(
            root,
            functools.partial(self._recurrent_fn, self.model, draws),
            self.search_cfg,
            torch.ones((B, self.K), dtype=torch.bool, device=dev),
            to_play=to_play.to(dev),
            with_noise=not deterministic,
            noise=noise,
            generator=g,
            device=dev,
        )
        slot, dist_entropy = sample_from_visit_counts(
            search_out.visit_counts, temperature, deterministic=deterministic, generator=g
        )
        return dict(
            action=root_actions[torch.arange(B, device=dev), slot],
            chosen_slot=slot,
            visit_counts=search_out.visit_counts,
            root_sampled_actions=root_actions,
            searched_value=search_out.root_value,
            predicted_value=pred_value,
            distribution_entropy=dist_entropy,
            **self._collect_telemetry(out0, search_out.visit_counts, root_actions),
        )

    def forward_reanalyze(self, *args, **kwargs):
        raise NotImplementedError(_REANALYZE_REFUSED)

    # ---------------------------------------------------------------- learn
    def _policy_loss(self, out, sampled: torch.Tensor, target: torch.Tensor):
        """(-Σ_j target_j log q(a_j), entropy) at one unroll position, over
        its stored candidates ``sampled`` (B, Ks, D) or (B, Ks[, 1])."""
        if self.discrete:
            acts = sampled.long()
            if acts.dim() == 3:
                acts = acts[..., 0]
            logp_all = torch.log_softmax(out.policy_logits, dim=-1)
            logp = torch.gather(logp_all, -1, acts)
            ent = -torch.sum(torch.softmax(out.policy_logits, dim=-1) * logp_all, dim=-1)
        else:
            logp = gaussian_tanh_logp(sampled, out.mu[:, None, :], out.sigma[:, None, :])
            ent = _gaussian_entropy(out.sigma)
        if bool(self.cfg.get("normalize_prob_of_sampled_actions", False)):
            # over the K candidates, with the denominator detached
            logp = logp - torch.logsumexp(logp, dim=-1, keepdim=True).detach()
        return -torch.sum(target * logp, dim=-1), ent

    def _ssl_term(self, model: nn.Module, latent: torch.Tensor, obs_next: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
        proj_dyn = model.project(latent, with_grad=True)
        with torch.no_grad():
            proj_obs = model.project(model.representation(obs_next), with_grad=False)
        return negative_cosine_similarity(proj_dyn, proj_obs) * mask

    def _sample_losses(self, model: nn.Module, batch: SampledTrainBatch):
        """Per-sample loss vector before importance weighting and reduction:
        ``(loss (B,), logs, value_priority (B,))`` (the JAX ``_loss_fn``,
        sampled_muzero.py:242-339)."""
        cfg = self.cfg
        base, sampled = batch.base, batch.sampled_actions
        K = self.num_unroll_steps
        tv_cat = phi_transform(self.value_support, scalar_transform(base.target_value))
        tr_cat = phi_transform(self.reward_support, scalar_transform(base.target_reward))

        out0 = model.initial_inference(base.obs[:, 0])
        value_loss = cross_entropy_loss(out0.value_logits, tv_cat[:, 0])
        policy_loss, entropy = self._policy_loss(out0, sampled[:, 0], base.target_policy[:, 0])
        policy_entropy_loss = -entropy
        pred_value0 = inverse_scalar_transform(out0.value_logits.detach(), self.value_support)
        value_priority = torch.abs(pred_value0 - base.target_value[:, 0])

        latent = out0.latent_state
        reward_loss = torch.zeros_like(value_loss)
        consistency_loss = torch.zeros_like(value_loss)
        for k in range(K):
            rec = model.recurrent_inference(latent, base.actions[:, k])
            latent = rec.latent_state
            if cfg.ssl_loss_weight > 0:
                consistency_loss = consistency_loss + self._ssl_term(
                    model, latent, base.obs[:, k + 1], base.mask[:, k])
            pl, ent = self._policy_loss(rec, sampled[:, k + 1], base.target_policy[:, k + 1])
            policy_loss = policy_loss + pl
            policy_entropy_loss = policy_entropy_loss - ent
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
            # the root's entropy, as in the JAX policy
            policy_entropy=entropy.mean(),
            predicted_value=pred_value0.mean(),
            target_value=base.target_value[:, 0].mean(),
        )
        return loss, {k: v.detach() for k, v in logs.items()}, value_priority

    def _loss_fn(self, model: nn.Module, batch: SampledTrainBatch):
        loss, logs, value_priority = self._sample_losses(model, batch)
        weighted_total_loss = torch.mean(batch.base.weights * loss)
        logs["total_loss"] = weighted_total_loss.detach()
        return weighted_total_loss / self.num_unroll_steps, (logs, value_priority)
