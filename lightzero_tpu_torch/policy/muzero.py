"""MuZero policy (``lightzero_tpu/policy/muzero.py``).

Serving: initial inference -> batched pUCT search -> action from the visit
counts, for collection (Dirichlet noise, temperature sampling,
epsilon-greedy, or the no-search pure-policy mode) and evaluation (no noise,
argmax).

Training: ``forward_learn`` unrolls the model ``num_unroll_steps`` steps and
takes one optimizer step on value, policy and reward cross-entropies, the
optional SSL cosine consistency loss and the policy-entropy term, weighted
by the batch's importance weights (with ``model.harmony_balance``, the
HarmonyDream weights instead: each of the policy, value and reward losses
divided by exp(h) of its learnable scalar, the entropy term dropped, and
log(exp(h) + 1) of each scalar added to the weighted mean; the variants whose
JAX policies replace this loss, ``harmony_loss`` False, refuse the option);
the loss is divided by the unroll length,
the gradients are clipped by their global norm as optax does, and the
target network is copied from the online one every ``target_update_freq``
steps. ``forward_reanalyze`` searches with the target network to refresh
the buffer's policy targets.

The JAX policy keeps all state in a ``TrainState`` pytree that its jitted
functions take and return. Here the policy holds the online model, which
collection and evaluation use, and ``TrainState`` holds that same module,
the target copy, the optimizer and its learning-rate schedule; the learn
step updates them in place.
"""
from __future__ import annotations

import copy
import functools
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from lightzero_tpu_torch.config import Config, deep_merge
from lightzero_tpu_torch.models import MuZeroModel
from lightzero_tpu_torch.ops import (
    DiscreteSupport,
    cross_entropy_loss,
    inverse_scalar_transform,
    phi_transform,
    scalar_transform,
)
from lightzero_tpu_torch.ops.action import sample_from_visit_counts
from lightzero_tpu_torch.search.puct import batch_puct_search
from lightzero_tpu_torch.search.types import RecurrentOutput, RootOutput, SearchConfig
from lightzero_tpu_torch.utils import profiling
from lightzero_tpu_torch.utils.device import resolve_device


class TrainState(NamedTuple):
    model: nn.Module  # the online network: the policy's own model
    target_model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_scheduler: torch.optim.lr_scheduler.LambdaLR
    train_iter: int


class TrainBatch(NamedTuple):
    """One training batch (assembled by the game buffer), on the policy's
    device.

    obs: (B, K+1, *obs_shape) observations at the unroll steps
    actions: (B, K) int64
    mask: (B, K) 1.0 while unroll step k+1 is inside the trajectory
    target_reward: (B, K) scalar rewards (transition k)
    target_value: (B, K+1) scalar n-step value targets
    target_policy: (B, K+1, A) visit-count distributions (zeros when masked)
    weights: (B,) importance-sampling weights
    chance: (B, K) true chance codes (zero for deterministic envs)
    """

    obs: torch.Tensor
    actions: torch.Tensor
    mask: torch.Tensor
    target_reward: torch.Tensor
    target_value: torch.Tensor
    target_policy: torch.Tensor
    weights: torch.Tensor
    chance: Optional[torch.Tensor] = None


def negative_cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-9)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=1e-9)
    return -torch.sum(a * b, dim=-1)


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: the gradients stay as they are while
    their global norm is below ``max_norm`` and are scaled by
    max_norm / norm otherwise (``clip_grad_norm_`` divides by norm + 1e-6
    instead). Returns the norm before clipping."""
    norm = torch.nn.utils.get_total_norm(grads)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def zero_missing_grads_(params) -> None:
    """A zero gradient for each parameter the loss does not reach, as JAX
    gives it; such a parameter still takes the weight decay's step."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


class MuZeroPolicy:
    """Holds the model, the search config and a generator for the search's
    and the action sampling's randomness."""

    # the task id a multitask policy's view binds for its collector,
    # evaluator and buffer (``policy/multitask.py``, ``task_view``): the
    # model's task embedding conditions their searches; None elsewhere
    _collect_task_id: Optional[int] = None
    # whether the policy's loss takes the HarmonyDream weights: the JAX
    # variants that replace MuZero's loss ignore model.harmony_balance
    harmony_loss = True
    # set by ``parallel.ddp.ddp_learn_step`` for one learn step: called with
    # (the model's parameters, the logs) between backward and the clip, it
    # averages the gradients and the logs over the ranks
    grad_sync: Optional[Callable] = None

    def _task_ids(self, batch_size: int) -> Optional[torch.Tensor]:
        """(B,) task ids of the bound task, or None outside a task view."""
        if self._collect_task_id is None:
            return None
        return torch.full((batch_size,), int(self._collect_task_id), dtype=torch.long,
                          device=self.device)

    @staticmethod
    def default_config() -> Config:
        """The JAX policy's defaults (``lightzero_tpu/policy/muzero.py:99``)."""
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
                    harmony_balance=False,
                ),
                batch_size=256,
                optim_type="Adam",  # 'SGD' | 'Adam' | 'AdamW'
                learning_rate=0.003,
                momentum=0.9,
                weight_decay=1e-4,
                grad_clip_value=10.0,
                piecewise_decay_lr_scheduler=False,
                threshold_training_steps_for_final_lr=int(5e4),
                num_unroll_steps=5,
                td_steps=5,
                discount_factor=0.997,
                num_simulations=50,
                root_dirichlet_alpha=0.3,
                root_noise_weight=0.25,
                pb_c_base=19652,
                pb_c_init=1.25,
                value_delta_max=0.01,
                ssl_loss_weight=0.0,
                policy_loss_weight=1.0,
                value_loss_weight=0.25,
                reward_loss_weight=1.0,
                policy_entropy_weight=0.0,
                target_update_freq=100,
                use_priority=True,
                priority_prob_alpha=0.6,
                priority_prob_beta=0.4,
                env_type="not_board_games",
                battle_mode="play_with_bot_mode",
                eval_freq=100,
                replay_ratio=0.25,
                n_episode=8,
                game_segment_length=200,
                replay_buffer_size=int(1e6),
                collect_epsilon=0.0,
                manual_temperature_decay=False,
                fixed_temperature_value=0.25,
                threshold_training_steps_for_final_temperature=int(1e5),
                reanalyze_ratio=0.0,
                reanalyze_noise=True,
                collect_with_pure_policy=False,
                reuse_search=False,
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
        if cfg.model.get("harmony_balance", False) and not self.harmony_loss:
            raise ValueError(
                f"the {cfg.get('type')} policy does not take model.harmony_balance: its JAX "
                "policy replaces MuZero's loss, builds a model without the HarmonyDream scalars "
                "and trains with the fixed loss weights without a word (ROADMAP queue 3)")
        scale = cfg.model.get("support_scale", 300)
        self.value_support = DiscreteSupport(-float(scale), float(scale) + 1.0, 1.0)
        self.reward_support = DiscreteSupport(-float(scale), float(scale) + 1.0, 1.0)
        if model is None:
            model_cfg = Config(dict(cfg.model))
            model_cfg.value_support_size = self.value_support.size
            model_cfg.reward_support_size = self.reward_support.size
            model = self._build_model(model_cfg, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.num_unroll_steps = int(cfg.num_unroll_steps)
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

    # ------------------------------------------------------------------ init
    def _build_model(self, model_cfg: Config, generator: torch.Generator) -> nn.Module:
        """The network of ``cfg.model``; variants build their own."""
        return MuZeroModel.from_config(model_cfg, generator)

    def _lr_schedule(self) -> Callable[[int], float]:
        """The learning rate's factor at a step count (optax schedules,
        muzero.py:197-212): constant; the cosine decay to ``alpha`` = 0.05
        of the rate, held there after ``cos_lr_decay_steps``; or the
        piecewise schedule, x0.1 from half and again from three quarters of
        ``threshold_training_steps_for_final_lr``."""
        cfg = self.cfg
        if cfg.get("cos_lr_scheduler", False):
            steps = int(cfg.get("cos_lr_decay_steps", 1e5))
            alpha = 0.05

            def cosine(count: int) -> float:
                count = min(count, steps)
                return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / steps)) + alpha

            return cosine
        if cfg.piecewise_decay_lr_scheduler:
            t = int(cfg.threshold_training_steps_for_final_lr)
            first, second = int(0.5 * t), int(0.75 * t)
            return lambda count: 0.1 ** ((count >= first) + (count >= second))
        return lambda count: 1.0

    def _make_optimizer(
        self, model: nn.Module
    ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
        """The optax chain of muzero.py:214-241 in torch: clip (done in the
        learn step, as optax does it) -> L2 decay -> SGD or Adam; or AdamW
        with decoupled decay, optionally only on tensors of rank >= 2
        (``selective_weight_decay``)."""
        cfg = self.cfg
        lr = float(cfg.learning_rate)
        wd = float(cfg.weight_decay)
        params = list(model.parameters())
        if cfg.optim_type == "SGD":
            # torch adds wd * p to the gradient before the momentum, as
            # optax's add_decayed_weights -> sgd does
            opt = torch.optim.SGD(params, lr=lr, momentum=float(cfg.momentum), weight_decay=wd)
        elif cfg.optim_type == "Adam":
            opt = torch.optim.Adam(params, lr=lr, eps=1e-8, weight_decay=wd)
        elif cfg.optim_type == "AdamW":
            if bool(cfg.get("selective_weight_decay", False)):
                groups = [
                    dict(params=[p for p in params if p.ndim >= 2], weight_decay=wd),
                    dict(params=[p for p in params if p.ndim < 2], weight_decay=0.0),
                ]
            else:
                groups = [dict(params=params, weight_decay=wd)]
            opt = torch.optim.AdamW(groups, lr=lr, eps=1e-8)
        else:
            raise ValueError(f"unknown optim_type {cfg.optim_type}")
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, self._lr_schedule())

    def init_train_state(self) -> TrainState:
        """The policy's model as the online network, a copy of it as the
        target, and a fresh optimizer (the JAX version also draws the
        params; here the policy drew them when it was built)."""
        target = copy.deepcopy(self.model).requires_grad_(False)
        optimizer, lr_scheduler = self._make_optimizer(self.model)
        return TrainState(self.model, target, optimizer, lr_scheduler, 0)

    # ------------------------------------------------------------ inference
    def _initial(self, model: nn.Module, obs: torch.Tensor,
                 task_id: Optional[torch.Tensor] = None):
        """The model's initial inference, conditioned on ``task_id``, or on
        the view's bound task when it is None (the models without a task
        embedding take the observation alone)."""
        if task_id is None:
            task_id = self._task_ids(obs.shape[0])
        if task_id is None:
            return model.initial_inference(obs)
        return model.initial_inference(obs, task_id)

    def _root_embedding(self, out0) -> Any:
        """Search embedding at the root; variants extend it."""
        return out0.latent_state

    def _recurrent_fn(self, model: nn.Module, action: torch.Tensor, embedding: Any) -> RecurrentOutput:
        out = model.recurrent_inference(embedding, action)
        return RecurrentOutput(
            reward=inverse_scalar_transform(out.reward_logits, self.reward_support),
            value=inverse_scalar_transform(out.value_logits, self.value_support),
            prior_logits=out.policy_logits,
            embedding=out.latent_state,
        )

    @torch.no_grad()
    def _bootstrap_value_fn(self, target_model: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        """Fresh target-net root values for the buffer's bootstrap targets."""
        out = self._initial(target_model, obs)
        return inverse_scalar_transform(out.value_logits, self.value_support)

    # ---------------------------------------------------------------- learn
    def _sample_losses(self, model: nn.Module, batch: TrainBatch,
                       task_id: Optional[torch.Tensor] = None, train_iter: Optional[int] = None):
        """Per-sample loss vector before importance weighting and reduction:
        ``(loss (B,), logs, value_priority (B,))``; the HarmonyDream
        regularizer, which the JAX version returns beside them, is
        ``_harmony_regularizer``. ``task_id`` (B,) conditions the root
        latent and the SSL target's representation when the model has a
        task embedding; ``train_iter`` is unused here, as in the JAX
        version."""
        cfg = self.cfg
        K = self.num_unroll_steps
        tv_cat = phi_transform(self.value_support, scalar_transform(batch.target_value))
        tr_cat = phi_transform(self.reward_support, scalar_transform(batch.target_reward))

        out0 = self._initial(model, batch.obs[:, 0], task_id)
        latent = out0.latent_state
        value_loss = cross_entropy_loss(out0.value_logits, tv_cat[:, 0])
        policy_loss = cross_entropy_loss(out0.policy_logits, batch.target_policy[:, 0])
        prob = torch.softmax(out0.policy_logits, dim=-1)
        entropy = -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-9)), dim=-1)
        policy_entropy_loss = -entropy
        pred_value0 = inverse_scalar_transform(out0.value_logits.detach(), self.value_support)
        value_priority = torch.abs(pred_value0 - batch.target_value[:, 0])

        reward_loss = torch.zeros_like(value_loss)
        consistency_loss = torch.zeros_like(value_loss)
        ssl = cfg.model.get("self_supervised_learning_loss", False) and cfg.ssl_loss_weight > 0

        for k in range(K):
            rec = model.recurrent_inference(latent, batch.actions[:, k])
            latent = rec.latent_state
            if ssl:
                proj_dyn = model.project(latent, with_grad=True)
                # the target branch carries no gradient (stop_gradient of
                # the projection of stop_gradient(representation))
                with torch.no_grad():
                    repr_k = model.representation(batch.obs[:, k + 1], task_id)
                    proj_obs = model.project(repr_k, with_grad=False)
                consistency_loss = consistency_loss + negative_cosine_similarity(
                    proj_dyn, proj_obs
                ) * batch.mask[:, k]
            policy_loss = policy_loss + cross_entropy_loss(
                rec.policy_logits, batch.target_policy[:, k + 1]
            )
            prob = torch.softmax(rec.policy_logits, dim=-1)
            entropy = -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-9)), dim=-1)
            policy_entropy_loss = policy_entropy_loss - entropy
            value_loss = value_loss + cross_entropy_loss(rec.value_logits, tv_cat[:, k + 1])
            reward_loss = reward_loss + cross_entropy_loss(rec.reward_logits, tr_cat[:, k])

        if cfg.model.get("harmony_balance", False):
            # HarmonyDream (reference muzero.py:563-575): each loss over
            # exp of its learnable scalar
            loss = (
                cfg.ssl_loss_weight * consistency_loss
                + policy_loss / torch.exp(model.harmony_policy)
                + value_loss / torch.exp(model.harmony_value)
                + reward_loss / torch.exp(model.harmony_reward)
            )
        else:
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
            # the last unroll step's entropy, as in the JAX policy
            policy_entropy=entropy.mean(),
            predicted_value=pred_value0.mean(),
            target_value=batch.target_value[:, 0].mean(),
        )
        return loss, {k: v.detach() for k, v in logs.items()}, value_priority

    def _harmony_regularizer(self, model: nn.Module) -> torch.Tensor:
        """HarmonyDream's log(exp(h) + 1) summed over the three scalars; a
        0-d zero without ``harmony_balance``."""
        if not self.cfg.model.get("harmony_balance", False):
            return torch.zeros((), device=self.device)
        return sum(torch.log(torch.exp(h) + 1.0) for h in (
            model.harmony_policy, model.harmony_value, model.harmony_reward))

    def _loss_fn(self, model: nn.Module, batch: TrainBatch):
        loss, logs, value_priority = self._sample_losses(model, batch)
        weighted_total_loss = torch.mean(batch.weights * loss) + self._harmony_regularizer(model)
        logs["total_loss"] = weighted_total_loss.detach()
        # the total gradient is scaled by 1/K (reference muzero.py:584-585)
        return weighted_total_loss / self.num_unroll_steps, (logs, value_priority)

    def forward_learn(self, state: TrainState, batch: TrainBatch):
        """One optimizer step (the JAX policy's ``_forward_learn``, which it
        jits as ``forward_learn``): ``(state, logs, value_priority (B,))``.
        The logs are 0-d tensors on the policy's device (``cur_lr`` a
        float)."""
        model = state.model
        state.optimizer.zero_grad(set_to_none=True)
        loss, (logs, value_priority) = self._loss_fn(model, batch)
        loss.backward()
        params = list(model.parameters())
        zero_missing_grads_(params)
        if self.grad_sync is not None:
            self.grad_sync(params, logs)
        logs["cur_lr"] = state.lr_scheduler.get_last_lr()[0]
        state, logs["grad_norm"] = self._update(state, [p.grad for p in params])
        return state, logs, value_priority

    def _update(self, state: TrainState, grads: Optional[List[torch.Tensor]],
                after_step: Optional[Callable[[], None]] = None):
        """The tail of a learn step: ``grads`` clipped by their global norm,
        the optimizer's and the schedule's step, ``after_step()``, then the
        target model's copy of the online one every ``target_update_freq``
        steps. ``grads`` None skips the update (a non-finite step) and still
        counts the step. Returns (the state, the norm of ``grads`` before
        clipping, None where skipped)."""
        norm = None
        with profiling.span("learn.optimizer"):
            if grads is not None:
                norm = clip_by_global_norm_(grads, float(self.cfg.grad_clip_value))
                state.optimizer.step()
                state.lr_scheduler.step()
                if after_step is not None:
                    after_step()
            train_iter = state.train_iter + 1
            if train_iter % int(self.cfg.target_update_freq) == 0:
                state.target_model.load_state_dict(state.model.state_dict())
        return state._replace(train_iter=train_iter), norm

    # -------------------------------------------------------------- collect
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
    ) -> Dict[str, torch.Tensor]:
        """Search from the observations' roots and act (``forward_collect``,
        ``forward_eval``). ``noise`` (B, A) replaces the Dirichlet draw (for
        tests)."""
        profiling.new_request()
        g = self.generator
        obs = obs.to(self.device, torch.float32)
        legal_mask = legal_mask.to(self.device)
        with profiling.span("model.initial"):
            out0 = self._initial(self.model, obs)
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
        return self._search_and_act(root, legal_mask, to_play, temperature, epsilon, deterministic,
                                    noise=noise)

    def _search_and_act(
        self,
        root: RootOutput,
        legal_mask: torch.Tensor,
        to_play: torch.Tensor,
        temperature: float,
        epsilon: float,
        deterministic: bool,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Search from ``root`` with the policy's model and pick the action
        from the visit counts, epsilon-greedy when collecting. ``noise``
        (B, A) replaces the Dirichlet draw (for tests)."""
        g = self.generator
        search_out = batch_puct_search(
            root,
            functools.partial(self._recurrent_fn, self.model),
            self.search_cfg,
            legal_mask,
            to_play=to_play.to(self.device),
            with_noise=not deterministic,
            noise=noise,
            generator=g,
            device=self.device,
        )
        with profiling.span("policy.act"):
            actions, dist_entropy = sample_from_visit_counts(
                search_out.visit_counts, temperature, deterministic=deterministic, generator=g
            )
            if not deterministic and epsilon > 0:
                # epsilon-greedy over legal actions (collect_epsilon, muzero.py:772)
                B = legal_mask.shape[0]
                rand_action = torch.multinomial(legal_mask.to(torch.float32), 1,
                                                generator=g).squeeze(-1)
                explore = torch.rand(B, generator=g, device=self.device) < epsilon
                actions = torch.where(explore, rand_action, actions)
        return dict(
            action=actions,
            visit_counts=search_out.visit_counts,
            searched_value=search_out.root_value,
            predicted_value=root.value,
            policy_logits=root.prior_logits,
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

    # ------------------------------------------------------------ reanalyze
    @torch.no_grad()
    def forward_reanalyze(
        self, target_model, obs, legal_mask, to_play=None, generator=None,
        true_action=None, reuse_value=None, noise=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Search again with the target network on stored observations: the
        normalized root visit distributions (the reanalyzed policy targets)
        and the root values. Root noise per ``reanalyze_noise``;
        ``generator`` (on the policy's device) draws it and the tie-break
        uniforms, the policy's own generator by default; ``noise`` (B, A)
        replaces the Dirichlet draw (for tests). ``true_action`` with
        ``reuse_value`` selects ReZero's reuse search (muzero.py:493-533)."""
        profiling.new_request()
        obs = obs.to(self.device, torch.float32)
        out0 = self._initial(target_model, obs)
        root = RootOutput(
            prior_logits=out0.policy_logits,
            value=inverse_scalar_transform(out0.value_logits, self.value_support),
            embedding=self._root_embedding(out0),
        )
        search_out = batch_puct_search(
            root,
            functools.partial(self._recurrent_fn, target_model),
            self.search_cfg,
            legal_mask.to(self.device),
            to_play=self._to_play(obs, to_play).to(self.device),
            with_noise=bool(self.cfg.get("reanalyze_noise", True)),
            noise=noise,
            true_action=true_action,
            reuse_value=reuse_value,
            generator=generator or self.generator,
            device=self.device,
        )
        counts = search_out.visit_counts.to(torch.float32)
        return counts / torch.clamp(counts.sum(-1, keepdim=True), min=1e-9), search_out.root_value
