"""Go 9x9 AlphaZero (komi 7.5), evaluated against the rule bot: the values of
``zoo/board_games/go/config/go_alphazero_bot_mode_config.py``, copied so
that the port never loads the zoo file (it imports
``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_az/go9_alphazero_ns100_seed0",
    env=dict(type="go", board_size=9, komi=7.5,
             battle_mode="play_with_bot_mode", stop_value=0.99,
             collector_env_num=8, evaluator_env_num=5, n_evaluator_episode=10),
    policy=dict(
        model=dict(observation_shape=(9, 9, 3), action_space_size=82,
                   num_channels=64, num_res_blocks=4),
        num_simulations=100, batch_size=256, update_per_collect=100, n_episode=8,
        eval_freq=200, manual_temperature_decay=True,
        threshold_training_steps_for_final_temperature=int(5e4),
    ),
))
