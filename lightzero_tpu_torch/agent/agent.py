"""High-level Agent API (``lightzero_tpu/agent/agent.py``; reference
lzero/agent, agent/muzero.py:29): ``Agent(env_id or cfg).train(...)``,
``.deploy()`` and ``.batch_evaluate()`` over bundled per-env configs, so
that a user can train and evaluate without writing a config file.

An agent runs on ``device``: ``cuda`` unless the caller names another (with
no GPU and no device named, building the agent raises). ``train`` goes
through ``entry.train_muzero``, or ``entry.train_alphazero`` for the
AlphaZero types; ``batch_evaluate`` builds the policy of
``cfg.policy.type`` on the device, loads a ``.pt`` checkpoint or params
export (``model_path``), and evaluates through the ``Evaluator`` on a
tensor env or the ``HostEvaluator`` on a host env (built as
``train_muzero`` builds its eval envs); ``deploy(enable_save_replay=True)``
saves each episode as ``episode_<i>.npz`` under ``replay_path``
(default ``<exp_name>/replays``).

Refused with ``ValueError``, where the JAX Agent fails (ROADMAP queue 3):
evaluating an AlphaZero-type agent (``JAX_AZ_EVAL_FAULT``) and saving
replays on a host env (``JAX_HOST_REPLAY_FAULT``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Union

import torch

from lightzero_tpu_torch.agent.configs import BUNDLED_CONFIGS as _ZOO
from lightzero_tpu_torch.config import Config, compile_config
from lightzero_tpu_torch.utils.device import resolve_device

# how the JAX Agent fails where the port refuses
JAX_AZ_EVAL_FAULT = (
    "the JAX Agent builds the AlphaZero policy without its env in batch_evaluate and raises "
    "TypeError: AlphaZeroPolicy.__init__() missing 1 required positional argument: 'env' "
    "(lightzero_tpu/agent/agent.py:145-148); evaluate it with entry.eval_alphazero")
JAX_HOST_REPLAY_FAULT = (
    "the JAX Agent passes save_replay_path to the host evaluator, which raises TypeError: "
    "HostEvaluator.eval() got an unexpected keyword argument 'save_replay_path' "
    "(lightzero_tpu/agent/agent.py:168-172)")

# legacy aliases kept for backward compatibility; the canonical bundled
# snapshot zoo lives in agent/configs.py (role of
# lzero/agent/config/<algo>/<env>.py)
_LEGACY_CONFIGS: Dict[str, Dict[str, Config]] = {
    "muzero": {
        "CartPole-v0": Config(
            dict(
                env=dict(env_id="CartPole-v0", stop_value=195, collector_env_num=8,
                         evaluator_env_num=3, n_evaluator_episode=3),
                policy=dict(
                    model=dict(observation_shape=4, action_space_size=2, model_type="mlp",
                               latent_state_dim=128, self_supervised_learning_loss=True),
                    num_simulations=25, batch_size=256, update_per_collect=100,
                    n_episode=8, eval_freq=100, ssl_loss_weight=2, learning_rate=0.003,
                ),
            )
        ),
        "Pendulum-v1": Config(
            dict(
                env=dict(env_id="Pendulum-v1", stop_value=-250, collector_env_num=8,
                         evaluator_env_num=3, n_evaluator_episode=3),
                policy=dict(
                    type="sampled_muzero",
                    model=dict(observation_shape=3, action_space_size=1, latent_state_dim=128),
                    num_simulations=50, num_of_sampled_actions=20, batch_size=256,
                    update_per_collect=100, n_episode=8, eval_freq=200, ssl_loss_weight=2,
                ),
            )
        ),
    },
    "efficientzero": {
        "CartPole-v0": Config(
            dict(
                env=dict(env_id="CartPole-v0", stop_value=195, collector_env_num=8,
                         evaluator_env_num=3, n_evaluator_episode=3),
                policy=dict(
                    type="efficientzero",
                    model=dict(observation_shape=4, action_space_size=2, model_type="mlp",
                               latent_state_dim=128, lstm_hidden_size=128),
                    num_simulations=25, batch_size=256, update_per_collect=100,
                    n_episode=8, eval_freq=100,
                ),
            )
        ),
    },
    "stochastic_muzero": {
        "game_2048": Config(
            dict(
                env=dict(env_id="game_2048", stop_value=int(1e9), collector_env_num=8,
                         evaluator_env_num=3, n_evaluator_episode=3),
                policy=dict(
                    type="stochastic_muzero",
                    model=dict(observation_shape=4 * 4 * 16, action_space_size=4,
                               chance_space_size=32, latent_state_dim=256),
                    num_simulations=50, batch_size=256, update_per_collect=100,
                    n_episode=8, eval_freq=200,
                    use_ture_chance_label_in_chance_encoder=True,
                ),
            )
        ),
    },
    "unizero": {
        "CartPole-v0": Config(
            dict(
                env=dict(env_id="CartPole-v0", stop_value=195, collector_env_num=8,
                         evaluator_env_num=3, n_evaluator_episode=3),
                policy=dict(
                    type="unizero",
                    model=dict(observation_shape=4, action_space_size=2, embed_dim=64,
                               num_layers=2, num_heads=4, max_tokens=16, support_scale=25),
                    num_simulations=25, num_unroll_steps=5, batch_size=64,
                    update_per_collect=60, n_episode=8, eval_freq=100, learning_rate=0.001,
                ),
            )
        ),
    },
}


class Agent:
    """``Agent('CartPole-v0').train(max_env_step=...)``, then ``.deploy()``
    or ``.batch_evaluate()``."""

    algo: str = "muzero"

    def __init__(self, env_id: Optional[str] = None, cfg: Optional[Config] = None,
                 exp_name: Optional[str] = None, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if cfg is None:
            table = dict(_LEGACY_CONFIGS.get(self.algo, {}))
            table.update(_ZOO.get(self.algo, {}))
            if env_id not in table:
                raise KeyError(
                    f"no bundled {self.algo} config for {env_id!r}; available: "
                    f"{sorted(table)}; pass cfg= explicitly"
                )
            cfg = Config(dict(table[env_id]))
        self.cfg = Config(dict(cfg))
        if exp_name:
            self.cfg.exp_name = exp_name
        self.cfg.setdefault("exp_name", f"data_agent/{self.algo}_{env_id}_seed{seed}")
        self.seed = seed
        self.policy = None
        self.state = None
        self._compiled_cfg = None

    def _policy_type(self, default: str) -> str:
        return self.cfg.get("policy", {}).get("type", default)

    def train(self, max_env_step: int = int(1e5), max_train_iter: int = int(1e9)) -> Dict:
        """Train through ``train_muzero`` (``train_alphazero`` for the
        AlphaZero types) and keep the trained policy: the entry's stats."""
        if "alphazero" in self._policy_type(self.algo):
            from lightzero_tpu_torch.entry import train_alphazero as entry
        else:
            from lightzero_tpu_torch.entry import train_muzero as entry

        self.policy, self.state, stats = entry(
            self.cfg, seed=self.seed, max_env_step=max_env_step,
            max_train_iter=max_train_iter, device=self.device)
        return stats

    def batch_evaluate(
        self,
        n_episodes: int = 5,
        model_path: Optional[str] = None,
        save_replay_path: Optional[str] = None,
    ) -> Dict:
        """Deterministic episodes with the trained policy, or with a fresh
        one that loads ``model_path``: the evaluator's record."""
        from lightzero_tpu_torch.entry.train_muzero import POLICIES, create_env, make_host_vec_env
        from lightzero_tpu_torch.utils.checkpoint import load_checkpoint_lenient

        ptype = self._policy_type("muzero")
        if "alphazero" in ptype:
            raise ValueError(f"Agent.batch_evaluate does not evaluate {ptype}: "
                             f"{JAX_AZ_EVAL_FAULT} (ROADMAP queue 3)")
        if self.policy is None or model_path is not None:
            pcls = POLICIES[ptype]
            cfg = compile_config(self.cfg, pcls.default_config(), self.seed, save_cfg=False)
            self.policy = pcls(cfg.policy, device=self.device, seed=self.seed)
            self.state = self.policy.init_train_state()
            if model_path:
                self.state = load_checkpoint_lenient(model_path, target=self.state)
            self._compiled_cfg = cfg
        cfg = self._compiled_cfg or self.cfg
        n_envs = cfg.env.get("evaluator_env_num", 3)
        env = create_env(cfg.env)
        if env is not None:
            from lightzero_tpu_torch.workers import Evaluator

            ev = Evaluator(env, self.policy, n_envs, seed=self.seed, device=self.device)
            return ev.eval(n_episodes=n_episodes, save_replay_path=save_replay_path)
        if save_replay_path is not None:
            raise ValueError(f"Agent.batch_evaluate saves no replay on the host env "
                             f"{cfg.env.get('env_id')!r}: {JAX_HOST_REPLAY_FAULT} "
                             "(ROADMAP queue 3)")
        from lightzero_tpu_torch.workers import HostEvaluator

        ev = HostEvaluator(make_host_vec_env(cfg.env, n_envs, self.seed), self.policy,
                           device=self.device)
        return ev.eval(n_episodes=n_episodes)

    def deploy(
        self,
        n_episodes: int = 1,
        model_path: Optional[str] = None,
        enable_save_replay: bool = False,
        replay_path: Optional[str] = None,
    ) -> Dict:
        """Deterministic episodes with the current or loaded model; with
        ``enable_save_replay`` each episode's trajectory is saved as .npz
        under ``replay_path`` (reference .deploy(enable_save_replay),
        agent/muzero.py:267)."""
        save_path = None
        if enable_save_replay:
            save_path = replay_path or os.path.join(
                str(self.cfg.get("exp_name", "data_agent/deploy")), "replays")
        return self.batch_evaluate(
            n_episodes=n_episodes, model_path=model_path, save_replay_path=save_path)


class MuZeroAgent(Agent):
    algo = "muzero"


class EfficientZeroAgent(Agent):
    algo = "efficientzero"


class UniZeroAgent(Agent):
    algo = "unizero"


class StochasticMuZeroAgent(Agent):
    algo = "stochastic_muzero"


class GumbelMuZeroAgent(Agent):
    algo = "gumbel_muzero"


class AlphaZeroAgent(Agent):
    algo = "alphazero"


class SampledAlphaZeroAgent(Agent):
    algo = "sampled_alphazero"


class SampledMuZeroAgent(Agent):
    algo = "sampled_muzero"


class SampledEfficientZeroAgent(Agent):
    algo = "sampled_efficientzero"
