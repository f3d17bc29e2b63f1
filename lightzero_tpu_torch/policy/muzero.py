"""MuZero policy, serving half (``lightzero_tpu/policy/muzero.py``): initial
inference -> batched pUCT search -> action from the visit counts, for
collection (Dirichlet noise, temperature sampling, epsilon-greedy, or the
no-search pure-policy mode) and evaluation (no noise, argmax).

Training (``_forward_learn``, the optimizer, the target network) waits for
the next slice of the port (ROADMAP queue 1, items 5 and 9).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from lightzero_tpu_torch.config import Config, deep_merge
from lightzero_tpu_torch.models import MuZeroModel
from lightzero_tpu_torch.ops import DiscreteSupport, inverse_scalar_transform
from lightzero_tpu_torch.ops.action import sample_from_visit_counts
from lightzero_tpu_torch.search.puct import batch_puct_search
from lightzero_tpu_torch.search.types import RecurrentOutput, RootOutput, SearchConfig
from lightzero_tpu_torch.utils.device import resolve_device


class MuZeroPolicy:
    """Holds the model, the search config and a generator for the search's
    and the action sampling's randomness."""

    @staticmethod
    def default_config() -> Config:
        """The serving keys of the JAX policy's defaults (muzero.py:99-167)."""
        return Config(
            dict(
                type="muzero",
                model=dict(
                    observation_shape=4,
                    action_space_size=2,
                    model_type="mlp",
                    latent_state_dim=256,
                    support_scale=300,
                    categorical_distribution=True,
                    self_supervised_learning_loss=False,
                    norm_type="LN",
                ),
                discount_factor=0.997,
                num_simulations=50,
                root_dirichlet_alpha=0.3,
                root_noise_weight=0.25,
                pb_c_base=19652,
                pb_c_init=1.25,
                value_delta_max=0.01,
                env_type="not_board_games",
                collect_epsilon=0.0,
                fixed_temperature_value=0.25,
                collect_with_pure_policy=False,
            )
        )

    def __init__(
        self,
        cfg: Optional[Dict] = None,
        model: Optional[MuZeroModel] = None,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        """``cfg`` is merged over ``default_config()``. Without ``model`` the
        network is built from ``cfg.model`` with weights drawn from ``seed``.
        The policy runs on ``device``: ``cuda`` unless the caller names
        another."""
        self.device = resolve_device(device)
        self.cfg = cfg = deep_merge(self.default_config(), cfg or {})
        scale = cfg.model.get("support_scale", 300)
        self.value_support = DiscreteSupport(-float(scale), float(scale) + 1.0, 1.0)
        self.reward_support = DiscreteSupport(-float(scale), float(scale) + 1.0, 1.0)
        if model is None:
            model_cfg = Config(dict(cfg.model))
            model_cfg.value_support_size = self.value_support.size
            model_cfg.reward_support_size = self.reward_support.size
            model = MuZeroModel.from_config(model_cfg, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.players = 2 if cfg.env_type == "board_games" else 1
        self.search_cfg = SearchConfig(
            num_simulations=cfg.num_simulations,
            pb_c_base=float(cfg.pb_c_base),
            pb_c_init=float(cfg.pb_c_init),
            discount=float(cfg.discount_factor),
            value_delta_max=float(cfg.value_delta_max),
            root_dirichlet_alpha=float(cfg.root_dirichlet_alpha),
            root_noise_weight=float(cfg.root_noise_weight),
            players=self.players,
        )
        self.generator = torch.Generator(self.device).manual_seed(seed)

    # ------------------------------------------------------------ inference
    def _initial(self, obs: torch.Tensor):
        return self.model.initial_inference(obs)

    def _root_embedding(self, out0) -> Any:
        """Search embedding at the root; variants extend it."""
        return out0.latent_state

    def _recurrent_fn(self, action: torch.Tensor, embedding: Any) -> RecurrentOutput:
        out = self.model.recurrent_inference(embedding, action)
        return RecurrentOutput(
            reward=inverse_scalar_transform(out.reward_logits, self.reward_support),
            value=inverse_scalar_transform(out.value_logits, self.value_support),
            prior_logits=out.policy_logits,
            embedding=out.latent_state,
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
    ) -> Dict[str, torch.Tensor]:
        g = self.generator
        obs = obs.to(self.device, torch.float32)
        legal_mask = legal_mask.to(self.device)
        out0 = self._initial(obs)
        pred_value = inverse_scalar_transform(out0.value_logits, self.value_support)
        if bool(self.cfg.get("collect_with_pure_policy", False)):
            # no-search mode (reference muzero.py:800-812): act from the
            # softmax policy over legal actions
            masked = torch.where(legal_mask, out0.policy_logits, -torch.inf)
            probs = torch.softmax(masked, dim=-1)
            if deterministic:
                actions = torch.argmax(masked, dim=-1)
            else:
                actions = torch.multinomial(probs, 1, generator=g).squeeze(-1)
            entropy = -torch.sum(probs * torch.log(torch.clamp(probs, min=1e-9)), dim=-1)
            return dict(
                action=actions,
                visit_counts=probs,
                searched_value=pred_value,
                predicted_value=pred_value,
                policy_logits=out0.policy_logits,
                distribution_entropy=entropy,
            )
        root = RootOutput(
            prior_logits=out0.policy_logits, value=pred_value, embedding=self._root_embedding(out0)
        )
        search_out = batch_puct_search(
            root,
            self._recurrent_fn,
            self.search_cfg,
            legal_mask,
            to_play=to_play.to(self.device),
            with_noise=not deterministic,
            generator=g,
            device=self.device,
        )
        actions, dist_entropy = sample_from_visit_counts(
            search_out.visit_counts, temperature, deterministic=deterministic, generator=g
        )
        if not deterministic and epsilon > 0:
            # epsilon-greedy over legal actions (collect_epsilon, muzero.py:772)
            B = legal_mask.shape[0]
            rand_action = torch.multinomial(legal_mask.to(torch.float32), 1, generator=g).squeeze(-1)
            explore = torch.rand(B, generator=g, device=self.device) < epsilon
            actions = torch.where(explore, rand_action, actions)
        return dict(
            action=actions,
            visit_counts=search_out.visit_counts,
            searched_value=search_out.root_value,
            predicted_value=pred_value,
            policy_logits=out0.policy_logits,
            distribution_entropy=dist_entropy,
        )

    def _to_play(self, obs: torch.Tensor, to_play: Optional[torch.Tensor]) -> torch.Tensor:
        if to_play is None:
            return torch.full((obs.shape[0],), -1, dtype=torch.int32, device=self.device)
        return to_play

    def forward_collect(
        self, obs, legal_mask, to_play=None, temperature: float = 1.0, epsilon: float = 0.0
    ) -> Dict[str, torch.Tensor]:
        """Search with root noise and sample the action from the visit counts."""
        return self._forward_collect(
            obs, legal_mask, self._to_play(obs, to_play), float(temperature), float(epsilon),
            deterministic=False,
        )

    def forward_eval(self, obs, legal_mask, to_play=None) -> Dict[str, torch.Tensor]:
        """Search without root noise and take the most visited action."""
        return self._forward_collect(
            obs, legal_mask, self._to_play(obs, to_play), 1.0, 0.0, deterministic=True
        )
