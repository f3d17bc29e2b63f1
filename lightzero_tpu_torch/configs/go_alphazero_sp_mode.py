"""Go 9x9 AlphaZero, self-play mode: the values of
``zoo/board_games/go/config/go_alphazero_sp_mode_config.py``, copied so that
the port never loads the zoo file (it imports ``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

board_size = 9

main_config = Config(dict(
    exp_name=f"data_az/go{board_size}_alphazero_sp_seed0",
    env=dict(type="go", battle_mode="self_play_mode", stop_value=0.7,
             board_size=board_size, komi=7.5,
             collector_env_num=8, evaluator_env_num=5, n_evaluator_episode=5),
    policy=dict(
        type="alphazero",
        model=dict(observation_shape=(board_size, board_size, 3),
                   action_space_size=board_size * board_size + 1,
                   num_channels=64, num_res_blocks=4),
        num_simulations=100, batch_size=256, update_per_collect=50,
        n_episode=8, eval_freq=500,
    ),
))
