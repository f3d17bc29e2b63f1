"""Jericho text-adventure host env (``lightzero_tpu/envs/jericho_env.py``),
gated on ``jericho``: each step's game text tokenized to ``max_seq_len``
input ids and an attention mask, the first ``max_action_num`` valid actions
as the legal mask, one player; optionally the stuck actions (whose response
leaves the text unchanged) pruned, and the location and inventory prepended
to the text. The text is tokenized by a HuggingFace tokenizer read from the
local files of ``tokenizer_path`` (nothing is downloaded), or else by
``hash_tokenize``. The ``HostVecEnv`` interface (``envs/host_env.py``), with
observations as a dict of (B, L) arrays ``input_ids`` and ``attn_mask``.

Without jericho, ``is_available()`` is False and building the env raises
``ImportError``.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

import numpy as np

from lightzero_tpu_torch.envs.host_env import no_player


def is_available() -> bool:
    try:
        import jericho  # noqa: F401

        return True
    except Exception:
        return False


def hash_tokenize(text: str, max_seq_len: int,
                  vocab_size: int = 32768) -> Tuple[np.ndarray, np.ndarray]:
    """Lower-cased whitespace words hashed by md5 into ids 2 .. vocab_size - 1
    (0 pads, 1 is kept for unknown), cut or zero-padded to ``max_seq_len``:
    (ids, attention mask), int64."""
    ids = []
    for w in text.lower().split()[:max_seq_len]:
        ids.append(int(hashlib.md5(w.encode()).hexdigest()[:8], 16) % (vocab_size - 2) + 2)
    n = len(ids)
    out = np.zeros(max_seq_len, np.int64)
    out[:n] = ids
    mask = np.zeros(max_seq_len, np.int64)
    mask[:n] = 1
    return out, mask


class JerichoVecEnv:
    def __init__(
        self,
        game_path: str,
        num_envs: int = 1,
        seed: int = 0,
        max_action_num: int = 10,
        max_seq_len: int = 512,
        max_steps: int = 400,
        tokenizer_path: Optional[str] = None,
        remove_stuck_actions: bool = False,
        add_location_and_inventory: bool = False,
    ):
        if not is_available():
            raise ImportError(
                "jericho is not installed; JerichoVecEnv is a gated adapter "
                "(the jericho configs load but cannot run)"
            )
        from jericho import FrotzEnv

        self.num_envs = num_envs
        self.max_action_num = max_action_num
        self.max_seq_len = max_seq_len
        self.max_steps = max_steps
        self.remove_stuck_actions = remove_stuck_actions
        self.add_location_and_inventory = add_location_and_inventory
        self.action_space_size = max_action_num
        self.observation_shape = max_seq_len
        self.continuous = False
        self._tok = None
        if tokenizer_path:
            try:
                from transformers import AutoTokenizer

                self._tok = AutoTokenizer.from_pretrained(tokenizer_path, local_files_only=True)
            except Exception:
                self._tok = None  # no local tokenizer: hash_tokenize
        self._envs = [FrotzEnv(game_path, seed=seed + i) for i in range(num_envs)]
        self._valid: List[List[str]] = [[] for _ in range(num_envs)]
        self._last_obs: List[str] = ["" for _ in range(num_envs)]
        self._steps = np.zeros(num_envs, np.int64)

    def _encode(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        if self._tok is not None:
            enc = self._tok(text, truncation=True, padding="max_length",
                            max_length=self.max_seq_len)
            return (np.asarray(enc["input_ids"], np.int64),
                    np.asarray(enc["attention_mask"], np.int64))
        return hash_tokenize(text, self.max_seq_len)

    def _obs_text(self, i: int, raw: str) -> str:
        if not self.add_location_and_inventory:
            return raw
        env = self._envs[i]
        try:
            loc = env.get_player_location().name
            inv = ", ".join(o.name for o in env.get_inventory())
            return f"location: {loc}. inventory: {inv}. {raw}"
        except Exception:
            return raw

    def _refresh_valid(self, i: int):
        self._valid[i] = list(self._envs[i].get_valid_actions())[: self.max_action_num]

    def _pack(self, texts: List[str]):
        ids, masks = zip(*(self._encode(t) for t in texts))
        legal = np.zeros((self.num_envs, self.max_action_num), bool)
        for i in range(self.num_envs):
            legal[i, : len(self._valid[i])] = True
            if not self._valid[i]:
                legal[i, 0] = True  # at least one legal arm
        return dict(input_ids=np.stack(ids), attn_mask=np.stack(masks)), legal

    def reset_all(self):
        texts = []
        for i, env in enumerate(self._envs):
            raw, _ = env.reset()
            self._steps[i] = 0
            self._last_obs[i] = raw
            self._refresh_valid(i)
            texts.append(self._obs_text(i, raw))
        obs, legal = self._pack(texts)
        return obs, legal, no_player(self.num_envs)

    def step(self, actions: np.ndarray):
        texts, rewards, dones = [], [], []
        for i, env in enumerate(self._envs):
            a = int(actions[i])
            cmd = self._valid[i][a] if a < len(self._valid[i]) else "look"
            raw, r, done, _ = env.step(cmd)
            self._steps[i] += 1
            if self.remove_stuck_actions and raw == self._last_obs[i] and cmd in self._valid[i]:
                self._valid[i].remove(cmd)  # prune the action that changed nothing
            else:
                self._refresh_valid(i)
            self._last_obs[i] = raw
            done = bool(done or self._steps[i] >= self.max_steps)
            if done:
                raw, _ = env.reset()
                self._steps[i] = 0
                self._refresh_valid(i)
            texts.append(self._obs_text(i, raw))
            rewards.append(float(r))
            dones.append(done)
        obs, legal = self._pack(texts)
        return (obs, np.asarray(rewards, np.float32), np.asarray(dones, bool), legal,
                no_player(self.num_envs))
