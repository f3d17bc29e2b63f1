"""AlphaZero policy (``lightzero_tpu/policy/alphazero.py``): a pUCT search in
which the environment is the simulator, and a learn step on the policy's
cross-entropy against the visit distribution and the value's squared error
against the game's outcome.

The search's embedding is the env state itself (a ``BoardState`` of
tensors): ``_recurrent_fn`` plays the action with the env's ``step_single``
and evaluates the new position with the network; where the game is over the
value is the outcome from the side of the player to move (+1 won, -1 lost,
0 drawn), and the env's legal mask and terminal flag go into the tree. The
search runs with ``players == 2`` and discount 1 from the state's own
``to_play``, so it takes the generic descent (``search/puct.py``), in bot
mode too.

The optimizer keeps optax's order (alphazero.py:102-111): the gradients are
clipped by their global norm first, then ``adamw`` (``optim_type`` "Adam":
the weights decay after the Adam step, not through the gradient, as
``torch.optim.AdamW`` does it) or ``add_decayed_weights`` followed by SGD
with momentum (``torch.optim.SGD`` with ``weight_decay``, which adds the
decay to the clipped gradient before the momentum).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Union

import torch
from torch import nn

from lightzero_tpu_torch.config import Config, deep_merge
from lightzero_tpu_torch.models.alphazero import AlphaZeroModel
from lightzero_tpu_torch.ops.action import sample_from_visit_counts
from lightzero_tpu_torch.policy.muzero import clip_by_global_norm_, zero_missing_grads_
from lightzero_tpu_torch.search.puct import batch_puct_search
from lightzero_tpu_torch.search.types import RecurrentOutput, RootOutput, SearchConfig
from lightzero_tpu_torch.utils import profiling
from lightzero_tpu_torch.utils.device import resolve_device


class AZTrainState(NamedTuple):
    model: nn.Module  # the policy's own network
    optimizer: torch.optim.Optimizer
    train_iter: int


class AZTrainBatch(NamedTuple):
    obs: torch.Tensor  # (B, H, W, C)
    target_policy: torch.Tensor  # (B, A) visit distributions of the searches
    target_value: torch.Tensor  # (B,) outcome in {-1, 0, 1} from the mover's side


class AlphaZeroPolicy:
    @staticmethod
    def default_config() -> Config:
        """The JAX policy's defaults (alphazero.py:48-80)."""
        return Config(
            dict(
                type="alphazero",
                model=dict(
                    observation_shape=(3, 3, 3),
                    action_space_size=9,
                    num_channels=32,
                    num_res_blocks=1,
                ),
                batch_size=256,
                optim_type="Adam",
                learning_rate=0.003,
                weight_decay=1e-4,
                grad_clip_value=10.0,
                momentum=0.9,
                value_weight=1.0,
                num_simulations=25,
                root_dirichlet_alpha=0.3,
                root_noise_weight=0.25,
                pb_c_base=19652,
                pb_c_init=1.25,
                value_delta_max=0.01,
                env_type="board_games",
                battle_mode="self_play_mode",
                eval_freq=100,
                n_episode=8,
                replay_buffer_size=int(1e5),
                manual_temperature_decay=False,
                fixed_temperature_value=1.0,
                threshold_training_steps_for_final_temperature=int(1e5),
                update_per_collect=50,
            )
        )

    def __init__(
        self,
        cfg: Optional[Dict],
        env,
        model: Optional[AlphaZeroModel] = None,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        """``cfg`` is merged over ``default_config()``; ``env`` is a board env
        (``step_single``, ``observation``, ``legal_mask``). Without ``model``
        the network is built from ``cfg.model`` with weights drawn from
        ``seed``. Runs on ``device``: ``cuda`` unless the caller names
        another."""
        self.device = resolve_device(device)
        self.cfg = cfg = deep_merge(self.default_config(), cfg or {})
        self.env = env
        if model is None:
            model = AlphaZeroModel.from_config(cfg.model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.search_cfg = SearchConfig(
            num_simulations=cfg.num_simulations,
            pb_c_base=float(cfg.pb_c_base),
            pb_c_init=float(cfg.pb_c_init),
            discount=1.0,
            value_delta_max=float(cfg.value_delta_max),
            root_dirichlet_alpha=float(cfg.root_dirichlet_alpha),
            root_noise_weight=float(cfg.root_noise_weight),
            players=2,
        )
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def _make_optimizer(self, model: nn.Module) -> torch.optim.Optimizer:
        cfg = self.cfg
        lr, wd = float(cfg.learning_rate), float(cfg.weight_decay)
        if cfg.optim_type == "SGD":
            return torch.optim.SGD(model.parameters(), lr=lr, momentum=float(cfg.momentum),
                                   weight_decay=wd)
        return torch.optim.AdamW(model.parameters(), lr=lr, eps=1e-8, weight_decay=wd)

    def init_train_state(self) -> AZTrainState:
        return AZTrainState(self.model, self._make_optimizer(self.model), 0)

    # ------------------------------------------------------------ inference
    def _recurrent_fn(self, action: torch.Tensor, env_state) -> RecurrentOutput:
        """One move in the env and the network at the new position; a
        finished game's value is its outcome from the side of the player to
        move (alphazero.py:118-141)."""
        ns = self.env.step_single(env_state, action)
        policy_logits, value = self.model(self.env.observation(ns))
        outcome = torch.where(ns.winner == 0, 0.0, torch.where(ns.winner == ns.to_play, 1.0, -1.0))
        value = torch.where(ns.done, outcome, value)
        return RecurrentOutput(
            reward=torch.zeros_like(value),
            value=value,
            prior_logits=policy_logits,
            embedding=ns,
            legal_mask=self.env.legal_mask(ns),
            terminal=ns.done,
        )

    def _root(self, env_state):
        """(observation, legal mask, root output) of the env states, the
        network evaluated at them."""
        obs = self.env.observation(env_state)
        policy_logits, value = self.model(obs)
        root = RootOutput(prior_logits=policy_logits, value=value, embedding=env_state)
        return obs, self.env.legal_mask(env_state), root

    @torch.no_grad()
    def _forward_collect(self, env_state, temperature: float, deterministic: bool = False,
                         noise: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Search from the env states (on the policy's device) and act:
        sampled from the visit counts at ``temperature``, or their argmax
        without root noise when ``deterministic``. ``noise`` (B, A)
        replaces the Dirichlet draw (for tests)."""
        profiling.new_request()
        obs, legal, root = self._root(env_state)
        return self._search_and_act(obs, root, legal, env_state.to_play, temperature,
                                    deterministic, noise)

    def _search_and_act(self, obs, root: RootOutput, legal: torch.Tensor, to_play: torch.Tensor,
                        temperature: float, deterministic: bool,
                        noise: Optional[torch.Tensor]) -> Dict[str, Any]:
        out = batch_puct_search(
            root,
            self._recurrent_fn,
            self.search_cfg,
            legal,
            to_play=to_play,
            with_noise=not deterministic,
            noise=noise,
            generator=self.generator,
            device=self.device,
        )
        actions, _ = sample_from_visit_counts(out.visit_counts, temperature,
                                              deterministic=deterministic,
                                              generator=self.generator)
        return dict(action=actions, visit_counts=out.visit_counts, searched_value=out.root_value,
                    predicted_value=root.value, obs=obs)

    def forward_collect(self, env_state, temperature: float = 1.0) -> Dict[str, Any]:
        return self._forward_collect(env_state, float(temperature), deterministic=False)

    def forward_eval(self, env_state) -> Dict[str, Any]:
        return self._forward_collect(env_state, 1.0, deterministic=True)

    # ---------------------------------------------------------------- learn
    def _loss_fn(self, model: nn.Module, batch: AZTrainBatch):
        policy_logits, value = model(batch.obs)
        log_probs = torch.log_softmax(policy_logits, dim=-1)
        policy_loss = -torch.sum(batch.target_policy * log_probs, dim=-1).mean()
        value_loss = torch.mean((value - batch.target_value) ** 2)
        prob = torch.softmax(policy_logits, dim=-1)
        entropy = -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-9)), dim=-1).mean()
        total = policy_loss + float(self.cfg.value_weight) * value_loss
        logs = dict(total_loss=total, policy_loss=policy_loss, value_loss=value_loss,
                    policy_entropy=entropy)
        return total, {k: v.detach() for k, v in logs.items()}

    def forward_learn(self, state: AZTrainState, batch: AZTrainBatch):
        """One optimizer step: ``(state, logs)``, the logs 0-d tensors on the
        policy's device."""
        state.optimizer.zero_grad(set_to_none=True)
        loss, logs = self._loss_fn(state.model, batch)
        loss.backward()
        logs["grad_norm"] = self._apply_gradients(state)
        return state._replace(train_iter=state.train_iter + 1), logs

    def _apply_gradients(self, state: AZTrainState) -> torch.Tensor:
        """The optimizer's step on the gradients the parameters hold, clipped
        by their global norm first; returns the norm before clipping."""
        params = list(state.model.parameters())
        zero_missing_grads_(params)
        norm = clip_by_global_norm_([p.grad for p in params], float(self.cfg.grad_clip_value))
        state.optimizer.step()
        return norm
