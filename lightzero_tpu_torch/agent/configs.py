"""Bundled per-env snapshot configs for the high-level Agent API
(``lightzero_tpu/agent/configs.py``, copied as literals over the port's
``Config``; role of reference lzero/agent/config/<algo>/<env>.py, the
HuggingFace model-zoo snapshots). Keys follow the reference's naming
(gym_cartpole_v0, tictactoe_play_with_bot, ...)."""
from __future__ import annotations

from lightzero_tpu_torch.config import Config


def _c(d) -> Config:
    return Config(d)


# ---------------- shared fragments ------------------------------------------
def _board_env(env_type: str, **kw):
    return dict(type=env_type, battle_mode="play_with_bot_mode", stop_value=0.99,
                collector_env_num=8, evaluator_env_num=5, **kw)


def _board_policy_common(obs_shape, A, td_steps):
    return dict(
        env_type="board_games",
        model=dict(observation_shape=obs_shape, action_space_size=A,
                   model_type="conv", num_channels=16, num_res_blocks=1,
                   downsample=False, support_scale=10),
        td_steps=td_steps, discount_factor=1.0, batch_size=256,
        update_per_collect=50, n_episode=8, eval_freq=2000,
        learning_rate=0.003, grad_clip_value=0.5,
    )


BUNDLED_CONFIGS = {
    # ------------------------------------------------------------- muzero
    "muzero": {
        "gym_cartpole_v0": _c(dict(
            env=dict(env_id="CartPole-v0", stop_value=195, collector_env_num=8,
                     evaluator_env_num=3, n_evaluator_episode=3),
            policy=dict(
                model=dict(observation_shape=4, action_space_size=2, model_type="mlp",
                           latent_state_dim=128, self_supervised_learning_loss=True),
                num_simulations=25, batch_size=256, update_per_collect=100,
                n_episode=8, eval_freq=100, ssl_loss_weight=2, learning_rate=0.003,
            ),
        )),
        "gym_pendulum_v1": _c(dict(
            env=dict(env_id="pendulum", stop_value=-200, collector_env_num=8,
                     evaluator_env_num=3, env_kwargs=dict(discrete_bins=11)),
            policy=dict(
                model=dict(observation_shape=3, action_space_size=11, model_type="mlp",
                           latent_state_dim=128),
                num_simulations=50, batch_size=256, update_per_collect=100,
                n_episode=8, eval_freq=200, learning_rate=0.003,
            ),
        )),
        "tictactoe_play_with_bot": _c(dict(
            env=_board_env("tictactoe"),
            policy=dict(num_simulations=25, num_unroll_steps=3,
                        **_board_policy_common((3, 3, 3), 9, td_steps=9)),
        )),
        "connect4_play_with_bot": _c(dict(
            env=_board_env("connect4"),
            policy=dict(num_simulations=50,
                        **{**_board_policy_common((6, 7, 3), 7, td_steps=21),
                           "model": dict(observation_shape=(6, 7, 3), action_space_size=7,
                                         model_type="conv", num_channels=64,
                                         num_res_blocks=1, downsample=False,
                                         support_scale=10)}),
        )),
        "gomoku_play_with_bot": _c(dict(
            env=_board_env("gomoku", env_kwargs=dict(board_size=6, n_in_row=4)),
            policy=dict(num_simulations=50,
                        **_board_policy_common((6, 6, 3), 36, td_steps=18)),
        )),
        "breakout_grid": _c(dict(
            env=dict(type="breakout_grid", stop_value=int(1e9), collector_env_num=8,
                     evaluator_env_num=3),
            policy=dict(
                model=dict(observation_shape=(10, 10, 4), action_space_size=3,
                           model_type="conv", num_channels=32, num_res_blocks=1,
                           downsample=False, self_supervised_learning_loss=True),
                num_simulations=25, batch_size=256, update_per_collect=100,
                n_episode=8, eval_freq=500, ssl_loss_weight=2,
            ),
        )),
    },
    # ------------------------------------------------------ efficientzero
    "efficientzero": {
        "gym_cartpole_v0": _c(dict(
            env=dict(env_id="CartPole-v0", stop_value=195, collector_env_num=8,
                     evaluator_env_num=3),
            policy=dict(
                type="efficientzero",
                model=dict(observation_shape=4, action_space_size=2, model_type="mlp",
                           latent_state_dim=128, lstm_hidden_size=128),
                num_simulations=25, batch_size=256, update_per_collect=100,
                n_episode=8, eval_freq=100,
            ),
        )),
        "gym_pendulum_v1": _c(dict(
            env=dict(env_id="pendulum", stop_value=-200, collector_env_num=8,
                     evaluator_env_num=3, env_kwargs=dict(discrete_bins=11)),
            policy=dict(
                type="efficientzero",
                model=dict(observation_shape=3, action_space_size=11, model_type="mlp",
                           latent_state_dim=128, lstm_hidden_size=128),
                num_simulations=50, batch_size=256, update_per_collect=100,
                n_episode=8, eval_freq=200,
            ),
        )),
    },
    # ------------------------------------------------------ gumbel_muzero
    "gumbel_muzero": {
        "gym_cartpole_v0": _c(dict(
            env=dict(env_id="CartPole-v0", stop_value=195, collector_env_num=8,
                     evaluator_env_num=3),
            policy=dict(
                type="gumbel_muzero",
                model=dict(observation_shape=4, action_space_size=2, model_type="mlp",
                           latent_state_dim=128),
                num_simulations=16, max_num_considered_actions=2, batch_size=256,
                update_per_collect=100, n_episode=8, eval_freq=100,
            ),
        )),
        "tictactoe_play_with_bot": _c(dict(
            env=_board_env("tictactoe"),
            policy=dict(type="gumbel_muzero", num_simulations=25,
                        max_num_considered_actions=9, num_unroll_steps=3,
                        **_board_policy_common((3, 3, 3), 9, td_steps=9)),
        )),
    },
    # ---------------------------------------------------------- alphazero
    "alphazero": {
        "tictactoe_play_with_bot": _c(dict(
            env=_board_env("tictactoe"),
            policy=dict(
                type="alphazero", env_type="board_games",
                model=dict(observation_shape=(3, 3, 3), action_space_size=9,
                           num_channels=16, num_res_blocks=1),
                num_simulations=25, batch_size=256, update_per_collect=50,
                n_episode=8, eval_freq=2000, learning_rate=0.003,
            ),
        )),
        "gomoku_play_with_bot": _c(dict(
            env=_board_env("gomoku", env_kwargs=dict(board_size=6, n_in_row=4)),
            policy=dict(
                type="alphazero", env_type="board_games",
                model=dict(observation_shape=(6, 6, 3), action_space_size=36,
                           num_channels=32, num_res_blocks=1),
                num_simulations=50, batch_size=256, update_per_collect=50,
                n_episode=8, eval_freq=2000, learning_rate=0.003,
            ),
        )),
    },
    # -------------------------------------------------- sampled_alphazero
    "sampled_alphazero": {
        "tictactoe_play_with_bot": _c(dict(
            env=_board_env("tictactoe"),
            policy=dict(
                type="sampled_alphazero", env_type="board_games",
                model=dict(observation_shape=(3, 3, 3), action_space_size=9,
                           num_channels=16, num_res_blocks=1),
                num_simulations=25, num_of_sampled_actions=5, batch_size=256,
                update_per_collect=50, n_episode=8, eval_freq=2000,
            ),
        )),
    },
    # --------------------------------------------- sampled_efficientzero
    "sampled_efficientzero": {
        "gym_pendulum_v1": _c(dict(
            env=dict(env_id="pendulum", stop_value=-200, collector_env_num=8,
                     evaluator_env_num=3),
            policy=dict(
                type="sampled_efficientzero",
                model=dict(observation_shape=3, action_space_size=1,
                           continuous_action_space=True, latent_state_dim=128,
                           lstm_hidden_size=128),
                num_simulations=50, num_of_sampled_actions=20, batch_size=256,
                update_per_collect=100, n_episode=8, eval_freq=200,
            ),
        )),
    },
    # --------------------------------------------------- sampled_muzero
    "sampled_muzero": {
        "gym_pendulum_v1": _c(dict(
            env=dict(env_id="pendulum", stop_value=-200, collector_env_num=8,
                     evaluator_env_num=3),
            policy=dict(
                type="sampled_muzero",
                model=dict(observation_shape=3, action_space_size=1,
                           continuous_action_space=True, latent_state_dim=128),
                num_simulations=50, num_of_sampled_actions=20, batch_size=256,
                update_per_collect=100, n_episode=8, eval_freq=200,
            ),
        )),
    },
    # ------------------------------------------------ stochastic_muzero
    "stochastic_muzero": {
        "game_2048": _c(dict(
            env=dict(type="game_2048", stop_value=int(1e9), collector_env_num=8,
                     evaluator_env_num=3),
            policy=dict(
                type="stochastic_muzero",
                model=dict(observation_shape=(4, 4, 16), action_space_size=4,
                           chance_space_size=32, model_type="conv", num_channels=32,
                           num_res_blocks=1, downsample=False, support_scale=300),
                num_simulations=50, batch_size=256, update_per_collect=100,
                n_episode=8, eval_freq=500, use_ture_chance_label_in_chance_encoder=True,
            ),
        )),
    },
    # ------------------------------------------------------------ unizero
    "unizero": {
        "gym_cartpole_v0": _c(dict(
            env=dict(env_id="CartPole-v0", stop_value=195, collector_env_num=8,
                     evaluator_env_num=3),
            policy=dict(
                type="unizero",
                model=dict(observation_shape=4, action_space_size=2, embed_dim=64,
                           num_layers=2, num_heads=4, max_tokens=16, support_scale=25),
                num_simulations=25, num_unroll_steps=5, batch_size=64,
                update_per_collect=60, n_episode=8, eval_freq=100, learning_rate=0.001,
            ),
        )),
        "memory_len_10": _c(dict(
            env=dict(type="memory", stop_value=0.95, collector_env_num=8,
                     evaluator_env_num=3, env_kwargs=dict(num_cues=4, memory_length=10)),
            policy=dict(
                type="unizero",
                model=dict(observation_shape=3 + 4 + 1, action_space_size=4,
                           embed_dim=64, num_layers=2, num_heads=4, max_tokens=28,
                           support_scale=5),
                num_simulations=15, num_unroll_steps=12, td_steps=12,
                discount_factor=1.0, batch_size=64, update_per_collect=50,
                n_episode=8, eval_freq=150, learning_rate=0.001,
            ),
        )),
    },
}
