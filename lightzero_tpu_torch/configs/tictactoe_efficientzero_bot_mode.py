"""TicTacToe EfficientZero against the rule bot: the values of
``zoo/board_games/tictactoe/config/tictactoe_efficientzero_bot_mode_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_sez/tictactoe_efficientzero_seed0",
    env=dict(type="tictactoe", battle_mode="play_with_bot_mode",
             stop_value=0.99,
             collector_env_num=8, evaluator_env_num=5, n_evaluator_episode=5),
    policy=dict(
        type="efficientzero", env_type="board_games",
        model=dict(observation_shape=(3, 3, 3), action_space_size=9,
                   model_type="conv", num_channels=16, num_res_blocks=1,
                   support_scale=1),
        num_simulations=25, batch_size=256, update_per_collect=50,
        n_episode=8, eval_freq=200, discount_factor=1.0, td_steps=9,
    ),
))
