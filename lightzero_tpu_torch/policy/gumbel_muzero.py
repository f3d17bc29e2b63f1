"""Gumbel MuZero policy (``lightzero_tpu/policy/gumbel_muzero.py``).

Collection and evaluation search with the Gumbel search (Sequential Halving
at the root) and act by the argmax of the improved policy over the legal
actions; evaluation takes the same path, Gumbel draws included, as in the
JAX policy. The stored policy target is the improved policy
softmax(logits + sigma(completed Q)), a float distribution where MuZero
stores visit counts: the collector normalizes it and the buffer and the
learn step treat it as they treat visit distributions. Reanalyze is
MuZero's, through the pUCT search and its descent kernel. On board games
(``env_type`` "board_games") the search has ``players == 2``, as the JAX
policy sets it (muzero.py:179).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.ops import inverse_scalar_transform
from lightzero_tpu_torch.policy.muzero import MuZeroPolicy
from lightzero_tpu_torch.search.gumbel import GumbelSearchConfig, batch_gumbel_search
from lightzero_tpu_torch.search.types import RootOutput


class GumbelMuZeroPolicy(MuZeroPolicy):
    @staticmethod
    def default_config() -> Config:
        cfg = MuZeroPolicy.default_config()
        cfg.type = "gumbel_muzero"
        cfg.max_num_considered_actions = 4
        return cfg

    def __init__(self, cfg=None, model=None, device=None, seed: int = 0):
        super().__init__(cfg, model=model, device=device, seed=seed)
        self.gumbel_cfg = GumbelSearchConfig(
            num_simulations=int(self.cfg.num_simulations),
            max_num_considered_actions=int(self.cfg.get("max_num_considered_actions", 4)),
            discount=float(self.cfg.discount_factor),
            players=self.players,
            value_delta_max=float(self.cfg.value_delta_max),
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
        gumbel: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """``temperature``, ``epsilon`` and ``deterministic`` are unused, as
        in the JAX policy. ``gumbel`` (B, A) replaces the search's Gumbel
        draw, for tests."""
        obs = obs.to(self.device, torch.float32)
        legal_mask = legal_mask.to(self.device)
        out0 = self.model.initial_inference(obs)
        pred_value = inverse_scalar_transform(out0.value_logits, self.value_support)
        root = RootOutput(
            prior_logits=out0.policy_logits, value=pred_value, embedding=self._root_embedding(out0)
        )
        search_out = batch_gumbel_search(
            root,
            functools.partial(self._recurrent_fn, self.model),
            self.gumbel_cfg,
            legal_mask,
            to_play=to_play.to(self.device),
            gumbel=gumbel,
            generator=self.generator,
            device=self.device,
        )
        probs = search_out.improved_policy
        # the action is the argmax of the improved policy (gumbel_muzero.py:591-592)
        actions = torch.argmax(torch.where(legal_mask, probs, -torch.inf), dim=-1)
        ent = -torch.sum(
            torch.where(probs > 0, probs * torch.log2(torch.clamp(probs, min=1e-30)), 0.0), dim=-1
        )
        return dict(
            action=actions,
            # the stored policy target is the improved policy, not raw visits
            visit_counts=probs,
            raw_visit_counts=search_out.visit_counts,
            searched_value=search_out.root_value,
            roots_completed_value=search_out.root_children_values,
            predicted_value=pred_value,
            policy_logits=out0.policy_logits,
            distribution_entropy=ent,
        )
