"""Gomoku 6x6 MuZero against the rule bot: the values of
``zoo/board_games/gomoku/config/gomoku_muzero_bot_mode_config.py``, copied
so that the port never loads the zoo file (it imports
``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

board_size = 6

main_config = Config(dict(
    exp_name=f"data_mz/gomoku{board_size}_muzero_seed0",
    env=dict(type="gomoku", battle_mode="play_with_bot_mode", stop_value=0.99,
             env_kwargs=dict(board_size=board_size, n_in_row=4),
             collector_env_num=8, evaluator_env_num=5, n_evaluator_episode=5),
    policy=dict(
        type="muzero", env_type="board_games",
        model=dict(observation_shape=(board_size, board_size, 3),
                   action_space_size=board_size * board_size,
                   model_type="conv", num_channels=32, num_res_blocks=1,
                   support_scale=1),
        num_simulations=50, batch_size=256, update_per_collect=50,
        n_episode=8, eval_freq=200, discount_factor=1.0,
        td_steps=board_size * board_size,
    ),
))
