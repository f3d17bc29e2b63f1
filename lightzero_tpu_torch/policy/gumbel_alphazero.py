"""Gumbel AlphaZero (``lightzero_tpu/policy/gumbel_alphazero.py``): AlphaZero
with the env as the simulator, searched by the two-player Gumbel search
(Sequential Halving over Gumbel-perturbed scores at the root,
``search/gumbel.py``) from the state's own ``to_play``, with discount 1. It
plays the argmax of the improved policy over the legal moves, exploration
coming from the Gumbel draws alone (no root noise, no temperature, the same
in evaluation), and stores the improved policy as the ``visit_counts``
training target, with the search's visit counts beside it as
``raw_visit_counts``. The learn step is AlphaZero's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.policy.alphazero import AlphaZeroPolicy
from lightzero_tpu_torch.search.gumbel import GumbelSearchConfig, batch_gumbel_search


class GumbelAlphaZeroPolicy(AlphaZeroPolicy):
    @staticmethod
    def default_config() -> Config:
        cfg = AlphaZeroPolicy.default_config()
        cfg.type = "gumbel_alphazero"
        cfg.max_num_considered_actions = 6
        return cfg

    def __init__(self, cfg, env, model=None, device=None, seed: int = 0):
        super().__init__(cfg, env, model=model, device=device, seed=seed)
        self.gumbel_cfg = GumbelSearchConfig(
            num_simulations=int(self.cfg.num_simulations),
            max_num_considered_actions=int(self.cfg.get("max_num_considered_actions", 6)),
            discount=1.0,
            players=2,
            value_delta_max=float(self.cfg.value_delta_max),
        )

    @torch.no_grad()
    def _forward_collect(self, env_state, temperature: float, deterministic: bool = False,
                         gumbel: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """``temperature`` and ``deterministic`` are unused, as in the JAX
        policy. ``gumbel`` (B, A) replaces the search's Gumbel draw
        (for tests)."""
        obs, legal, root = self._root(env_state)
        out = batch_gumbel_search(root, self._recurrent_fn, self.gumbel_cfg, legal,
                                  to_play=env_state.to_play, gumbel=gumbel,
                                  generator=self.generator, device=self.device)
        actions = torch.argmax(torch.where(legal, out.improved_policy, -torch.inf), dim=-1)
        return dict(action=actions, visit_counts=out.improved_policy,
                    raw_visit_counts=out.visit_counts, searched_value=out.root_value,
                    predicted_value=root.value, obs=obs)
