"""Gomoku 6x6 Gumbel AlphaZero (32 simulations, 8 considered actions): the
values of
``zoo/board_games/gomoku/config/gomoku_gumbel_alphazero_config.py``, copied
so that the port never loads the zoo file (it imports
``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_gaz/gomoku_gumbel_alphazero_seed0",
    env=dict(type="gomoku", board_size=6, n_in_row=4,
             battle_mode="play_with_bot_mode", stop_value=0.99,
             collector_env_num=8, evaluator_env_num=5),
    policy=dict(
        type="gumbel_alphazero",
        model=dict(observation_shape=(6, 6, 3), action_space_size=36,
                   num_channels=32, num_res_blocks=1),
        num_simulations=32, max_num_considered_actions=8,
        batch_size=256, update_per_collect=50, n_episode=8, eval_freq=100,
    ),
))
