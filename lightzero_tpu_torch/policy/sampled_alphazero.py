"""Sampled AlphaZero (``lightzero_tpu/policy/sampled_alphazero.py``):
AlphaZero whose search considers only K = ``num_of_sampled_actions`` legal
moves at each node, for big boards. The subset is a mask: the Gumbel-top-K
of the policy logits over the legal moves (``gumbel_top_k_mask``, the same
as drawing K moves from the softmax without replacement), laid over the
root's legal mask and over each expanded node's (``_recurrent_fn``). Its
Gumbel draws come from the policy's generator, one (B, A) table for the
root and one per simulation; tests hand in the JAX policy's (``root_gumbel``,
``sim_gumbel``). Action choice and learn step are AlphaZero's.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import torch

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.policy.alphazero import AlphaZeroPolicy
from lightzero_tpu_torch.search.types import RecurrentOutput
from lightzero_tpu_torch.utils import profiling


def gumbel_top_k_mask(logits: torch.Tensor, legal: torch.Tensor, k: int,
                      gumbel: torch.Tensor) -> torch.Tensor:
    """(B, A) bool: the k legal actions of the largest logits + ``gumbel``
    (standard Gumbel draws, (B, A)), or every legal action where there are
    no more than k (sampled_alphazero.py:22-33)."""
    scores = torch.where(legal, logits + gumbel.to(logits), -torch.inf)
    # the k-th largest score; JAX clamps the index when k exceeds A
    kth = torch.sort(scores, dim=-1).values[:, max(scores.shape[-1] - k, 0)][:, None]
    few = legal.sum(dim=-1, keepdim=True) <= k
    return torch.where(few, legal, (scores >= kth) & legal)


class SampledAlphaZeroPolicy(AlphaZeroPolicy):
    @staticmethod
    def default_config() -> Config:
        cfg = AlphaZeroPolicy.default_config()
        cfg.type = "sampled_alphazero"
        cfg.num_of_sampled_actions = 8
        return cfg

    def __init__(self, cfg, env, model=None, device=None, seed: int = 0):
        super().__init__(cfg, env, model=model, device=device, seed=seed)
        self.K = int(self.cfg.get("num_of_sampled_actions", 8))
        self._sim_gumbel: Optional[Iterator[torch.Tensor]] = None

    def _draw_gumbel(self, like: torch.Tensor) -> torch.Tensor:
        u = torch.rand(like.shape, generator=self.generator, device=like.device, dtype=like.dtype)
        return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(like.dtype).tiny)))

    def _recurrent_fn(self, action: torch.Tensor, env_state) -> RecurrentOutput:
        out = super()._recurrent_fn(action, env_state)
        g = (next(self._sim_gumbel) if self._sim_gumbel is not None
             else self._draw_gumbel(out.prior_logits))
        return out._replace(legal_mask=gumbel_top_k_mask(out.prior_logits, out.legal_mask,
                                                         self.K, g))

    @torch.no_grad()
    def _forward_collect(self, env_state, temperature: float, deterministic: bool = False,
                         noise: Optional[torch.Tensor] = None,
                         root_gumbel: Optional[torch.Tensor] = None,
                         sim_gumbel: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """AlphaZero's collect step on the root's sampled subset.
        ``root_gumbel`` (B, A) and ``sim_gumbel`` (num_simulations, B, A)
        replace the subsets' Gumbel draws (for tests)."""
        profiling.new_request()
        obs, legal, root = self._root(env_state)
        g = root_gumbel.to(self.device) if root_gumbel is not None else self._draw_gumbel(
            root.prior_logits)
        root_legal = gumbel_top_k_mask(root.prior_logits, legal, self.K, g)
        self._sim_gumbel = None if sim_gumbel is None else iter(sim_gumbel.to(self.device))
        try:
            return self._search_and_act(obs, root, root_legal, env_state.to_play, temperature,
                                        deterministic, noise)
        finally:
            self._sim_gumbel = None
