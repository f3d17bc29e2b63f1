"""MuZero-Context policy (``lightzero_tpu/policy/muzero_context.py``).

Training and reanalyze are MuZero's. Collection and evaluation differ: the
root latent of each real env step is the previous step's root latent rolled
one step through the dynamics network with the action taken, instead of a
fresh encoding of the observation. The observation is encoded again at an
episode's first step (``last_action < 0``) and, as a context reset, at every
step whose timestep before the increment is a positive multiple of
``context_length_init`` (the reference's check after the recurrent update,
muzero_context_model.py:249-256).

The context is an explicit state ``dict(latent, last_action, timestep)``,
per env, that the collector and the evaluator thread through their step
loops (``stateful_collect``) and reset per env when an episode ends. With
the conv model the context's latent is (B, h, w, C), h and w the
observation's divided by 16 under ``downsample`` (the JAX policy's
``h // 16``; the port takes the representation's own output size, which is
the same on every config that runs there).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.ops import inverse_scalar_transform
from lightzero_tpu_torch.policy.muzero import MuZeroPolicy
from lightzero_tpu_torch.search.types import RootOutput
from lightzero_tpu_torch.utils import profiling

CollectState = Dict[str, torch.Tensor]


class MuZeroContextPolicy(MuZeroPolicy):
    stateful_collect = True

    @staticmethod
    def default_config() -> Config:
        cfg = MuZeroPolicy.default_config()
        cfg.type = "muzero_context"
        # the period of the context reset (muzero_context_model.py)
        cfg.context_length_init = 5
        return cfg

    def init_collect_state(self, batch_size: int) -> CollectState:
        """(latent 0, last_action -1, timestep 0) for each of ``batch_size``
        envs."""
        dev = self.device
        model = self.model
        shape = model.latent_shape if model.model_type == "conv" else (model.latent_state_dim,)
        return dict(
            latent=torch.zeros((batch_size, *shape), device=dev),
            last_action=torch.full((batch_size,), -1, dtype=torch.long, device=dev),
            timestep=torch.zeros((batch_size,), dtype=torch.long, device=dev),
        )

    def reset_collect_state(self, state: CollectState, done: torch.Tensor) -> CollectState:
        """Envs whose episode ended start again with action -1 (which forces
        the encoding of the next observation)."""
        fresh = self.init_collect_state(done.shape[0])
        done = done.to(self.device)
        return {k: torch.where(done.reshape((-1,) + (1,) * (v.dim() - 1)), fresh[k], v)
                for k, v in state.items()}

    @torch.no_grad()
    def _forward_collect_stateful(
        self,
        obs: torch.Tensor,
        legal_mask: torch.Tensor,
        to_play: torch.Tensor,
        temperature: float,
        epsilon: float,
        collect_state: CollectState,
        deterministic: bool = False,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[Dict[str, torch.Tensor], CollectState]:
        """One search from the context's root latent: (the outputs of
        ``_forward_collect``, the next context). ``noise`` (B, A) replaces
        the Dirichlet draw (for tests)."""
        profiling.new_request()
        model = self.model
        obs = obs.to(self.device, torch.float32)
        legal_mask = legal_mask.to(self.device)
        last_action = collect_state["last_action"]
        timestep = collect_state["timestep"]
        encoded = model.representation(obs)
        rolled, _ = model.dynamics(collect_state["latent"], torch.clamp(last_action, min=0))
        ctx = int(self.cfg.get("context_length_init", 5))
        reencode = (last_action < 0) | ((timestep % ctx == 0) & (timestep > 0))
        root_latent = torch.where(reencode.reshape((-1,) + (1,) * (encoded.dim() - 1)),
                                  encoded, rolled)
        value_logits, policy_logits = model.prediction(root_latent)
        root = RootOutput(
            prior_logits=policy_logits,
            value=inverse_scalar_transform(value_logits, self.value_support),
            embedding=root_latent,
        )
        out = self._search_and_act(root, legal_mask, to_play, temperature, epsilon,
                                   deterministic, noise=noise)
        return out, dict(latent=root_latent, last_action=out["action"].long(),
                         timestep=timestep + 1)
