"""Go 6x6 AlphaZero (komi 4.5), evaluated against the rule bot: the values of
``zoo/board_games/go/config/go6_alphazero_bot_mode_config.py``, copied so
that the port never loads the zoo file (it imports
``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

board_size = 6

main_config = Config(dict(
    exp_name=f"data_az/go{board_size}_alphazero_seed0",
    env=dict(type="go", battle_mode="play_with_bot_mode", stop_value=0.95,
             collector_env_num=8, evaluator_env_num=5, n_evaluator_episode=10,
             env_kwargs=dict(board_size=board_size, komi=4.5)),
    policy=dict(
        model=dict(observation_shape=(board_size, board_size, 3),
                   action_space_size=board_size * board_size + 1,
                   num_channels=64, num_res_blocks=2),
        num_simulations=60, batch_size=256, update_per_collect=50, n_episode=8,
        use_augmentation=True,  # 8-fold dihedral orbit; pass is invariant
        eval_freq=100, manual_temperature_decay=True,
        threshold_training_steps_for_final_temperature=int(5e4),
    ),
))
