"""TicTacToe Gumbel AlphaZero: the values of
``zoo/board_games/tictactoe/config/tictactoe_gumbel_alphazero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_gaz/tictactoe_gumbel_alphazero_seed0",
    env=dict(type="tictactoe", battle_mode="play_with_bot_mode", stop_value=0.99,
             collector_env_num=8, evaluator_env_num=5, n_evaluator_episode=10),
    policy=dict(
        type="gumbel_alphazero",
        model=dict(observation_shape=(3, 3, 3), action_space_size=9, num_channels=32),
        num_simulations=16, max_num_considered_actions=4, batch_size=256,
        update_per_collect=50, n_episode=8, eval_freq=100,
    ),
))
