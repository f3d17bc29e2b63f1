"""Connect4 AlphaZero, evaluated against the rule bot: the values of
``zoo/board_games/connect4/config/connect4_alphazero_bot_mode_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_az/connect4_alphazero_ns50_seed0",
    env=dict(type="connect4", battle_mode="play_with_bot_mode", stop_value=0.99,
             collector_env_num=8, evaluator_env_num=5, n_evaluator_episode=10),
    policy=dict(
        model=dict(observation_shape=(6, 7, 3), action_space_size=7,
                   num_channels=64, num_res_blocks=2),
        num_simulations=50, batch_size=256, update_per_collect=50, n_episode=8,
        eval_freq=100, manual_temperature_decay=True,
        threshold_training_steps_for_final_temperature=int(2e4),
    ),
))
