"""TicTacToe AlphaZero in self-play mode: the values of
``zoo/board_games/tictactoe/config/tictactoe_alphazero_sp_mode_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_az/tictactoe_alphazero_sp_seed0",
    env=dict(type="tictactoe", battle_mode="self_play_mode", stop_value=0.7,
             collector_env_num=8, evaluator_env_num=5, n_evaluator_episode=5),
    policy=dict(
        type="alphazero",
        model=dict(observation_shape=(3, 3, 3), action_space_size=9,
                   num_channels=32, num_res_blocks=1),
        num_simulations=25, batch_size=256, update_per_collect=50,
        n_episode=8, eval_freq=200,
    ),
))
