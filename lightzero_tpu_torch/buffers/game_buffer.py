"""Replay buffer with priority sampling, n-step value targets and
(optionally reanalyzed) policy targets: the MuZero path of
``lightzero_tpu/buffers/game_buffer.py``.

Whole episodes are stored on the host as numpy arrays, with one priority per
transition. A batch is assembled on the host, by the native core
(``csrc/replay_core.cpp``) or by the Python loops, then the target network's
bootstrap values and, at ``reanalyze_ratio > 0``, the reanalyze search run
on the policy's device, and the batch goes to that device once.

Randomness: one ``np.random.RandomState(seed + 4096)``, drawn in the JAX
buffer's order (the native sampler's seed, the padding actions, and once the
seed of the reanalyze search's ``torch.Generator``), so that the same
episodes give the same samples in both packages.

Episodes of the sampled policies (root candidates stored) take the Python
path, as in the JAX buffer: their actions are (T, D) floats (or ints) and
the batch is a ``SampledTrainBatch`` with the root candidates of every
unroll position.

A policy with ``reanalyze_needs_context`` (UniZero) also gets, for every
reanalyzed position, the stored observations and actions of the
``reanalyze_context_steps`` steps before it (``_context_history``).

ReZero's whole-buffer reanalyze (``reanalyze_buffer``) searches again, with
the target network, the newest transitions up to a share of the buffer and
overwrites their stored policy targets and root values in place; with
``reuse_search`` it goes backward in time through each episode so that every
search reuses its successor's fresh root value. Its randomness comes from the
policy's generator, where the JAX buffer takes a key from its caller.

Board games (``env_type`` "board_games"): in self-play
(``battle_mode`` "self_play_mode" in the policy's config, as the JAX buffer
reads it) the value targets are the game's outcome from the side of the
player to move at each unroll position, instead of the n-step returns
(game_buffer.py:74-82, 425-450); against the bot the rewards are already
the agent's and the n-step targets stay. ``mirror_augmentation`` (column
games such as Connect4, A == board width) mirrors each sampled unroll left
to right with probability 1/2, after reanalyze: the observations' W axis,
the actions (a -> A - 1 - a) and the policy targets together
(game_buffer.py:204-260). Its coin flips are drawn from the buffer's
``RandomState`` after the batch's own draws, in the JAX buffer's order, or
taken from ``flips`` where a caller hands them in.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from lightzero_tpu_torch.buffers import native
from lightzero_tpu_torch.policy.muzero import TrainBatch
from lightzero_tpu_torch.policy.sampled_muzero import SampledTrainBatch


class EpisodeRecord(NamedTuple):
    """One finished (or truncated) episode, host numpy arrays of length T."""

    obs: np.ndarray  # (T, *obs_shape) raw observation before action t
    actions: np.ndarray  # (T,) ints, or (T, D) floats in a continuous action space
    rewards: np.ndarray  # (T,)
    child_visits: np.ndarray  # (T, A) root visit distributions (normalized)
    root_values: np.ndarray  # (T,) searched root values
    legal_mask: np.ndarray  # (T, A)
    to_play: np.ndarray  # (T,)
    truncated: bool = False  # episode cut by collection end (not terminal)
    chance: Optional[np.ndarray] = None  # (T,) true chance codes
    # (T, Ks, D) root sampled actions ((T, Ks) indices when discrete) of
    # the sampled policies
    root_sampled_actions: Optional[np.ndarray] = None
    # (P, *obs_shape) observations of the P steps before this record's start
    # when it continues a mid-episode flush; frame stacking reads them
    # instead of zero padding
    prefix_obs: Optional[np.ndarray] = None


class GameBuffer:
    """MuZero replay buffer (one-player and board-game modes)."""

    def __init__(self, cfg, policy):
        self.cfg = cfg
        self.policy = policy
        self._episodes: List[EpisodeRecord] = []
        self._priorities: List[np.ndarray] = []
        self._total_transitions = 0
        self._pushed_transitions = 0  # every transition pushed, evicted or not
        self.capacity = int(cfg.replay_buffer_size)
        self.alpha = float(cfg.priority_prob_alpha)
        self.beta = float(cfg.priority_prob_beta)
        self.K = int(cfg.num_unroll_steps)
        self.td_steps = int(cfg.td_steps)
        self.discount = float(cfg.discount_factor)
        self.use_priority = bool(cfg.get("use_priority", True))
        self.reanalyze_ratio = float(cfg.get("reanalyze_ratio", 0.0))
        self.frame_stack = int(cfg.get("frame_stack_num", 1))
        self.board_mode = cfg.get("env_type", "not_board_games") == "board_games"
        # winner-z targets only for self-play trajectories, whose to_play
        # alternates between 1 and 2 (game_buffer.py:79-82)
        self.winner_z_targets = (
            self.board_mode and cfg.get("battle_mode", "self_play_mode") == "self_play_mode")
        self.mirror_augmentation = bool(cfg.get("mirror_augmentation", False))
        self._rng = np.random.RandomState(cfg.get("seed", 0) + 4096)
        self._re_generator: Optional[torch.Generator] = None
        # the native core assembles batches; the Python loops only when the
        # config asks for them. A failed build of the core raises here.
        self._use_native = bool(cfg.get("use_native_replay", True))
        if self._use_native:
            native.library()
        self._flat_dirty = True
        self._flat_priorities = np.zeros(0, np.float64)
        self._flat_ep = np.zeros(0, np.int64)
        self._flat_pos = np.zeros(0, np.int64)

    # ------------------------------------------------------------------ push
    def push_episodes(self, episodes: List[EpisodeRecord], priorities: Optional[List[np.ndarray]] = None):
        for i, ep in enumerate(episodes):
            T = len(ep.actions)
            if T == 0:
                continue
            if priorities is not None and priorities[i] is not None:
                p = np.asarray(priorities[i], np.float64)
            else:
                p = np.full(T, self._max_priority(), np.float64)
            self._episodes.append(ep)
            self._priorities.append(np.maximum(p, 1e-6))
            self._total_transitions += T
            self._pushed_transitions += T
        self._evict()
        self._flat_dirty = True

    def _max_priority(self) -> float:
        if not self._priorities:
            return 1.0
        return max(float(p.max()) for p in self._priorities)

    def _evict(self):
        """Drop the oldest episodes until the buffer fits its capacity (one
        episode always stays)."""
        while self._total_transitions > self.capacity and len(self._episodes) > 1:
            ep = self._episodes.pop(0)
            self._priorities.pop(0)
            self._total_transitions -= len(ep.actions)
        self._flat_dirty = True

    @property
    def num_transitions(self) -> int:
        return self._total_transitions

    @property
    def num_episodes(self) -> int:
        return len(self._episodes)

    # ---------------------------------------------------------------- sample
    def _rebuild_flat(self):
        if not self._flat_dirty:
            return
        lengths = [len(p) for p in self._priorities]
        self._flat_ep = np.repeat(np.arange(len(lengths), dtype=np.int64), lengths)
        self._flat_pos = (
            np.concatenate([np.arange(T, dtype=np.int64) for T in lengths])
            if lengths else np.zeros(0, np.int64)
        )
        self._flat_priorities = (
            np.concatenate(self._priorities) if lengths else np.zeros(0, np.float64)
        )
        self._ep_start = np.cumsum([0] + lengths)[:-1].astype(np.int64)
        self._ep_len = np.asarray(lengths, np.int64)
        self._ep_trunc = np.asarray([ep.truncated for ep in self._episodes], np.uint8)
        # contiguous pools for the native path's bulk gathers
        if self._episodes and self._use_native:
            self._flat_obs = np.concatenate([e.obs for e in self._episodes])
            self._flat_actions = np.concatenate([e.actions for e in self._episodes])
            self._flat_rewards = np.concatenate([e.rewards for e in self._episodes]).astype(
                np.float32
            )
            self._flat_policies = np.concatenate([e.child_visits for e in self._episodes])
            self._flat_chance = np.concatenate([
                e.chance if e.chance is not None else np.zeros(len(e.actions), np.int64)
                for e in self._episodes
            ])
        self._flat_dirty = False

    def sample(self, batch_size: int, target_model: nn.Module, flips: Optional[np.ndarray] = None
               ) -> Tuple[Union[TrainBatch, SampledTrainBatch], np.ndarray]:
        """Returns (the batch on the policy's device, flat sample indices
        for ``update_priority``). ``flips`` (B,) bool replaces the mirror
        augmentation's coin flips (for tests)."""
        self._rebuild_flat()
        n = len(self._flat_priorities)
        if n == 0:
            raise ValueError("the buffer is empty")
        if self.use_priority and self._use_native:
            idx, weights = native.sample_prioritized(
                self._flat_priorities, self.alpha, self.beta, batch_size,
                int(self._rng.randint(1 << 31)),
            )
        elif self.use_priority:
            probs = self._flat_priorities ** self.alpha
            probs = probs / probs.sum()
            idx = self._rng.choice(n, size=batch_size, p=probs, replace=True)
            weights = (n * probs[idx]) ** (-self.beta)
            weights = weights / weights.max()
        else:
            idx = self._rng.randint(0, n, size=batch_size)
            weights = np.ones(batch_size)
        batch = self._make_batch(idx, target_model, np.asarray(weights, np.float32))
        if self.mirror_augmentation:
            batch = self._mirror_augment(batch, flips)
        return batch, idx

    def _mirror_augment(self, batch: TrainBatch, flips: Optional[np.ndarray] = None) -> TrainBatch:
        """Mirror each sample left to right with probability 1/2 (column-action
        boards, A == W): the observations' W axis, the actions and the
        policy targets together; values and rewards are mirror-invariant
        (game_buffer.py:204-260)."""
        if not isinstance(batch, TrainBatch):
            raise TypeError("mirror_augmentation is only supported for TrainBatch (discrete "
                            f"column-action boards); got {type(batch).__name__}")
        if batch.chance is not None and bool((batch.chance != 0).any()):
            raise ValueError("mirror_augmentation cannot be combined with nontrivial chance "
                             "codes (stochastic envs)")
        if batch.obs.dim() < 4:
            raise ValueError("mirror_augmentation requires board-shaped obs (B, K+1, H, W[, C]); "
                             f"got obs.ndim={batch.obs.dim()}")
        W = int(batch.obs.shape[-2])
        A = int(batch.target_policy.shape[-1])
        if A != W or batch.actions.is_floating_point():
            raise ValueError("mirror_augmentation requires column-action boards (A == obs W, "
                             f"discrete actions); got A={A} W={W} dtype={batch.actions.dtype}")
        B = int(batch.obs.shape[0])
        if flips is None:
            flips = self._rng.rand(B) < 0.5
        flip = torch.from_numpy(np.asarray(flips, bool)).to(batch.obs.device)

        def pick(mirrored, orig):
            return torch.where(flip.reshape((B,) + (1,) * (orig.dim() - 1)), mirrored, orig)

        return batch._replace(
            obs=pick(batch.obs.flip(-2), batch.obs),
            actions=pick((A - 1) - batch.actions, batch.actions),
            target_policy=pick(batch.target_policy.flip(-1), batch.target_policy),
        )

    def update_priority(self, idx: np.ndarray, new_priorities: np.ndarray):
        """Priorities from |predicted - target| value of the learn step."""
        self._rebuild_flat()
        new_p = np.maximum(np.asarray(new_priorities, np.float64), 1e-6)
        self._flat_priorities[idx] = new_p
        for j, flat_i in enumerate(np.asarray(idx)):
            self._priorities[self._flat_ep[flat_i]][self._flat_pos[flat_i]] = new_p[j]

    # ---------------------------------------------------------------- rezero
    def _search_rows(self, rows, target_model: nn.Module, **reuse):
        """One reanalyze search over the stored positions ``rows`` ((episode,
        position, ...) tuples): (normalized visits, root values), on the
        policy's device."""
        dev = self.policy.device
        eps = [(self._episodes[r[0]], r[1]) for r in rows]
        obs = np.stack([self._stacked_obs(ep, t) for ep, t in eps]).astype(np.float32)
        legal = np.stack([ep.legal_mask[t] for ep, t in eps])
        to_play = np.asarray([ep.to_play[t] for ep, t in eps])
        return self.policy.forward_reanalyze(
            target_model, torch.from_numpy(obs).to(dev), torch.from_numpy(legal).to(dev),
            torch.from_numpy(to_play).to(dev, torch.int32), **reuse,
        )

    def _write_targets(self, rows, fresh: torch.Tensor, values: torch.Tensor) -> None:
        fresh, values = fresh.cpu().numpy(), values.cpu().numpy()
        for j, (e, t) in enumerate(rows):
            self._episodes[e].child_visits[t] = fresh[j]
            self._episodes[e].root_values[t] = values[j]

    def reanalyze_buffer(self, target_model: nn.Module, reanalyze_batch_size: int = 256,
                         partition: float = 0.75, reuse_search: bool = False) -> int:
        """ReZero's periodic whole-buffer reanalyze (game_buffer.py:263-320):
        search again with ``target_model`` the newest episodes until they
        hold ``partition`` of the stored transitions, in batches of
        ``reanalyze_batch_size`` (the last padded with its own last row),
        and overwrite their policy targets and root values in place. With
        ``reuse_search`` the episodes go backward in time and each search
        reuses its successor's root value. Returns the number of
        transitions reanalyzed."""
        if reuse_search:
            n = self._reanalyze_buffer_with_reuse(target_model, reanalyze_batch_size, partition)
        else:
            budget = int(self._total_transitions * partition)
            todo = []  # (episode, position), newest episodes first
            for e in range(len(self._episodes) - 1, -1, -1):
                todo += [(e, t) for t in range(len(self._episodes[e].actions))]
                if len(todo) >= budget:
                    break
            for start in range(0, len(todo), reanalyze_batch_size):
                chunk = todo[start:start + reanalyze_batch_size]
                padded = chunk + [chunk[-1]] * (reanalyze_batch_size - len(chunk))
                self._write_targets(chunk, *self._search_rows(padded, target_model))
            n = len(todo)
        # the native path serves policy targets from the flat pool: rebuild
        # it so that the fresh targets are sampled from now on
        self._flat_dirty = True
        return n

    def _reanalyze_buffer_with_reuse(self, target_model: nn.Module, group_size: int,
                                     partition: float) -> int:
        """Backward-in-time reanalyze with root-value reuse
        (game_buffer.py:322-391): episodes in groups of ``group_size``;
        iteration k searches every episode's position T_e - k, k = 1 with a
        plain search, every later k with the stored action as
        ``true_action`` and the previous iteration's root values as
        ``reuse_value``. Rows keep JAX's layout: G = ``group_size`` rows,
        one per episode of the group, then padding rows at (group[0], 0);
        an episode already done searches its position 0 again. Only the
        valid rows are written back."""
        budget = int(self._total_transitions * partition)
        eps, covered = [], 0  # newest episodes first
        for e in range(len(self._episodes) - 1, -1, -1):
            eps.append(e)
            covered += len(self._episodes[e].actions)
            if covered >= budget:
                break
        G = max(1, int(group_size))
        done_count = 0
        for gstart in range(0, len(eps), G):
            group = eps[gstart:gstart + G]
            lengths = [len(self._episodes[e].actions) for e in group]
            reuse_value = None
            for k in range(1, max(lengths) + 1):
                pos = [T - k for T in lengths]
                rows = [(e, max(p, 0), p >= 0) for e, p in zip(group, pos)]
                rows += [(group[0], 0, False)] * (G - len(rows))
                reuse = {}
                if k > 1:
                    actions = np.asarray([self._episodes[e].actions[p] for e, p, _ in rows])
                    reuse = dict(true_action=torch.from_numpy(actions).to(self.policy.device),
                                 reuse_value=reuse_value)
                fresh, reuse_value = self._search_rows(rows, target_model, **reuse)
                keep = [j for j, (_, _, v) in enumerate(rows) if v]
                self._write_targets([rows[j][:2] for j in keep], fresh[keep], reuse_value[keep])
                done_count += len(keep)
        return done_count

    # ------------------------------------------------------------- targets
    def _stacked_obs(self, ep: EpisodeRecord, pos: int) -> np.ndarray:
        """Frame-stacked observation window ending at pos (zero-padded
        before the episode's start), concatenated on the last axis."""
        if self.frame_stack == 1:
            return ep.obs[pos]
        frames = []
        P = len(ep.prefix_obs) if ep.prefix_obs is not None else 0
        for k in range(pos - self.frame_stack + 1, pos + 1):
            if k >= 0:
                frames.append(ep.obs[k])
            elif P + k >= 0:
                frames.append(ep.prefix_obs[P + k])
            else:
                frames.append(np.zeros_like(ep.obs[0]))
        return np.concatenate(frames, axis=-1)

    def _bootstrap_values(self, target_model: nn.Module, obs: np.ndarray) -> np.ndarray:
        """(M, *obs) -> (M,) target-net root values, computed on the
        policy's device."""
        obs = torch.from_numpy(np.ascontiguousarray(obs, np.float32)).to(self.policy.device)
        return self.policy._bootstrap_value_fn(target_model, obs).cpu().numpy()

    def _board_game_value_targets(self, idx) -> np.ndarray:
        """(B, K+1) winner-z value targets of self-play board games: the
        game's outcome from the side of the player to move at each unroll
        position, 0 for a draw, an unfinished (truncated) game and past the
        episode's end (game_buffer.py:425-450)."""
        K = self.K
        z = np.zeros((len(idx), K + 1), np.float32)
        for b, flat_i in enumerate(idx):
            ep = self._episodes[self._flat_ep[flat_i]]
            pos = int(self._flat_pos[flat_i])
            T = len(ep.actions)
            last_mover = int(ep.to_play[T - 1])
            final_r = float(ep.rewards[T - 1])
            # +1: the last mover won; -1: the last mover lost; 0: a draw
            if final_r > 0:
                winner = last_mover
            elif final_r < 0:
                winner = 3 - last_mover if last_mover in (1, 2) else 0
            else:
                winner = 0
            if ep.truncated:
                winner = 0
            for k in range(K + 1):
                t = pos + k
                if t < T and winner != 0:
                    z[b, k] = 1.0 if int(ep.to_play[t]) == winner else -1.0
        return z

    def _apply_reanalyze(self, idx, target_policy, target_model):
        """Reanalyze the first ceil(B * ratio) samples: fresh search policy
        targets from the target net (reference reanalyze_ratio mixing,
        game_buffer_muzero.py:179-190)."""
        B = len(idx)
        K = self.K
        A = target_policy.shape[-1]
        n_re = int(np.ceil(B * self.reanalyze_ratio)) if self.reanalyze_ratio > 0 else 0
        if n_re == 0:
            return target_policy
        obs_shape = self._stacked_obs(self._episodes[0], 0).shape
        re_obs = np.zeros((n_re, K + 1) + obs_shape, np.float32)
        re_legal = np.zeros((n_re, K + 1, A), bool)
        re_to_play = np.full((n_re, K + 1), -1, np.int64)
        re_valid = np.zeros((n_re, K + 1), np.float32)
        for b in range(n_re):
            ep = self._episodes[self._flat_ep[idx[b]]]
            pos = int(self._flat_pos[idx[b]])
            T = len(ep.actions)
            for k in range(K + 1):
                t = pos + k
                if t < T:
                    re_obs[b, k] = self._stacked_obs(ep, t)
                    re_legal[b, k] = ep.legal_mask[t]
                    re_to_play[b, k] = ep.to_play[t]
                    re_valid[b, k] = 1.0
                else:
                    re_legal[b, k, :] = True  # avoid an empty legal set
        M = n_re * (K + 1)
        if self._re_generator is None:
            # the JAX buffer seeds its reanalyze PRNGKey with this one draw
            self._re_generator = torch.Generator(self.policy.device).manual_seed(
                int(self._rng.randint(1 << 30))
            )
        dev = self.policy.device
        context = {}
        H = int(self.policy.cfg.get("reanalyze_context_steps", 4))
        if getattr(self.policy, "reanalyze_needs_context", False) and H > 0:
            oh, ah, hl = self._context_history(idx[:n_re], H, obs_shape)
            context = dict(obs_hist=torch.from_numpy(oh.reshape((M, H + 1) + obs_shape)).to(dev),
                           act_hist=torch.from_numpy(ah.reshape(M, H)).to(dev),
                           hist_len=torch.from_numpy(hl.reshape(M)).to(dev))
        fresh_policy, _ = self.policy.forward_reanalyze(
            target_model,
            torch.from_numpy(re_obs.reshape((M,) + obs_shape)).to(dev),
            torch.from_numpy(re_legal.reshape(M, A)).to(dev),
            torch.from_numpy(re_to_play.reshape(M)).to(dev, torch.int32),
            generator=self._re_generator,
            **context,
        )
        fresh_policy = fresh_policy.cpu().numpy().reshape(n_re, K + 1, A)
        target_policy = np.array(target_policy)
        target_policy[:n_re] = fresh_policy * re_valid[..., None]
        return target_policy

    def _context_history(self, idx, H: int, obs_shape) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The stored history before each reanalyzed position, for a policy
        whose reanalyze root is the prefill of its context (UniZero,
        game_buffer.py:484-508): observations (n, K+1, H+1, *obs) and actions
        (n, K+1, H) ending at step t = min(pos + k, T - 1), aligned to the
        right, and the valid history length min(t, H) (n, K+1). The native
        path takes this loop too, as the JAX buffer does."""
        K = self.K
        n = len(idx)
        oh = np.zeros((n, K + 1, H + 1) + tuple(obs_shape), np.float32)
        ah = np.zeros((n, K + 1, H), np.int64)
        hl = np.zeros((n, K + 1), np.int64)
        for b in range(n):
            ep = self._episodes[self._flat_ep[idx[b]]]
            pos = int(self._flat_pos[idx[b]])
            T = len(ep.actions)
            for k in range(K + 1):
                t = min(pos + k, T - 1)
                length = min(t, H)
                hl[b, k] = length
                for i in range(length + 1):
                    oh[b, k, H - i] = self._stacked_obs(ep, t - i)
                for i in range(length):
                    ah[b, k, H - 1 - i] = ep.actions[t - 1 - i]
        return oh, ah, hl

    def _to_device(self, obs, actions, mask, target_reward, target_value, target_policy,
                   weights, chance, sampled_actions=None) -> Union[TrainBatch, SampledTrainBatch]:
        dev = self.policy.device

        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

        batch = TrainBatch(
            obs=put(obs, torch.float32),
            actions=put(actions, torch.float32 if actions.dtype.kind == "f" else torch.int64),
            mask=put(mask, torch.float32),
            target_reward=put(target_reward, torch.float32),
            target_value=put(target_value, torch.float32),
            target_policy=put(target_policy, torch.float32),
            weights=put(weights, torch.float32),
            chance=put(chance, torch.int64),
        )
        if sampled_actions is None:
            return batch
        return SampledTrainBatch(base=batch, sampled_actions=put(sampled_actions, torch.float32))

    def _make_batch_native(self, idx: np.ndarray, target_model: nn.Module, weights: np.ndarray) -> TrainBatch:
        """The native path: C++ index assembly and numpy bulk gathers."""
        K, td, gamma = self.K, self.td_steps, self.discount
        B = len(idx)
        ep = self._flat_ep[idx]
        out = native.assemble_unroll(
            self._ep_start[ep], self._ep_len[ep], self._flat_pos[idx],
            self._ep_trunc[ep], self._flat_rewards, K, td, gamma,
        )
        obs_valid = out["obs_valid"].astype(bool)
        obs_shape = self._flat_obs.shape[1:]
        obs = np.where(
            obs_valid.reshape(B, K + 1, *([1] * len(obs_shape))),
            self._flat_obs[out["obs_idx"]],
            0.0,
        ).astype(np.float32)
        target_policy = np.where(
            obs_valid[..., None], self._flat_policies[out["obs_idx"]], 0.0
        ).astype(np.float32)
        pad = out["action_pad"].astype(bool)
        A = self._flat_policies.shape[1]
        actions = np.where(
            pad, self._rng.randint(0, A, size=(B, K)), self._flat_actions[out["action_idx"]]
        )
        target_reward = np.where(pad, 0.0, self._flat_rewards[out["action_idx"]]).astype(
            np.float32
        )
        if self.winner_z_targets:
            target_value = self._board_game_value_targets(idx)
        else:
            boot_obs = self._flat_obs[out["boot_idx"]].astype(np.float32)
            boot_v = self._bootstrap_values(
                target_model, boot_obs.reshape((B * (K + 1),) + obs_shape)
            ).reshape(B, K + 1)
            target_value = out["reward_sum"] + out["boot_disc"] * boot_v * out["boot_valid"]
        target_policy = self._apply_reanalyze(idx, target_policy, target_model)
        chance = np.where(pad, 0, self._flat_chance[out["action_idx"]])
        return self._to_device(obs, actions, out["mask"], target_reward, target_value,
                               target_policy, weights, chance)

    def _make_batch(self, idx: np.ndarray, target_model: nn.Module, weights: np.ndarray
                    ) -> Union[TrainBatch, SampledTrainBatch]:
        self._rebuild_flat()
        K, td, gamma = self.K, self.td_steps, self.discount
        B = len(idx)
        rsa0 = self._episodes[0].root_sampled_actions
        if self._use_native and self.frame_stack == 1 and rsa0 is None:
            return self._make_batch_native(idx, target_model, weights)
        obs_shape = self._stacked_obs(self._episodes[0], 0).shape
        A = self._episodes[0].child_visits.shape[1]

        obs = np.zeros((B, K + 1) + obs_shape, np.float32)
        chance = np.zeros((B, K), np.int64)
        act0 = self._episodes[0].actions
        continuous = act0.dtype.kind == "f" or act0.ndim > 1
        act_shape = act0.shape[1:]
        actions = np.zeros((B, K) + act_shape, np.float32 if continuous else np.int64)
        sampled_actions = (np.zeros((B, K + 1) + rsa0.shape[1:], np.float32)
                           if rsa0 is not None else None)
        mask = np.zeros((B, K), np.float32)
        target_reward = np.zeros((B, K), np.float32)
        reward_sum = np.zeros((B, K + 1), np.float32)
        boot_obs = np.zeros((B, K + 1) + obs_shape, np.float32)
        boot_valid = np.zeros((B, K + 1), np.float32)
        boot_discount = np.zeros((B, K + 1), np.float32)
        target_policy = np.zeros((B, K + 1, A), np.float32)

        for b, flat_i in enumerate(idx):
            ep = self._episodes[self._flat_ep[flat_i]]
            pos = int(self._flat_pos[flat_i])
            T = len(ep.actions)
            for k in range(K + 1):
                t = pos + k
                if t >= T:
                    continue  # beyond the episode: all-zero (absorbing) targets
                obs[b, k] = self._stacked_obs(ep, t)
                cv = ep.child_visits[t]
                s = cv.sum()
                if s > 0:
                    target_policy[b, k] = cv / s
                if sampled_actions is not None:
                    sampled_actions[b, k] = ep.root_sampled_actions[t]
                # n-step value target pieces; a truncated (time-limit)
                # episode caps the horizon at T-1 so that its tail
                # bootstraps from the last stored obs
                horizon = T - 1 if ep.truncated else T
                td_eff = max(min(td, horizon - t), 0)
                r = 0.0
                for i in range(td_eff):
                    r += (gamma ** i) * ep.rewards[t + i]
                reward_sum[b, k] = r
                boot_t = t + td_eff
                if boot_t < T:
                    boot_obs[b, k] = self._stacked_obs(ep, boot_t)
                    boot_valid[b, k] = 1.0
                    boot_discount[b, k] = gamma ** td_eff
            for k in range(K):
                t = pos + k
                if t < T:
                    actions[b, k] = ep.actions[t]
                    target_reward[b, k] = ep.rewards[t]
                    if ep.chance is not None:
                        chance[b, k] = ep.chance[t]
                    if t + 1 < T:
                        mask[b, k] = 1.0
                elif continuous:
                    actions[b, k] = self._rng.uniform(-1, 1, size=act_shape)
                else:
                    actions[b, k] = self._rng.randint(0, A)

        if self.winner_z_targets:
            target_value = self._board_game_value_targets(idx)
        else:
            boot_v = self._bootstrap_values(
                target_model, boot_obs.reshape((B * (K + 1),) + obs_shape)
            ).reshape(B, K + 1)
            target_value = reward_sum + boot_discount * boot_v * boot_valid
        target_policy = self._apply_reanalyze(idx, target_policy, target_model)
        return self._to_device(obs, actions, mask, target_reward, target_value, target_policy,
                               weights, chance, sampled_actions)
