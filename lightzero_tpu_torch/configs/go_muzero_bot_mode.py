"""Go 9x9 MuZero against the rule bot: the values of
``zoo/board_games/go/config/go_muzero_bot_mode_config.py``, copied so that
the port never loads the zoo file (it imports ``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_mz/go9_muzero_ns100_seed0",
    env=dict(type="go", board_size=9, komi=7.5,
             battle_mode="play_with_bot_mode", stop_value=0.99,
             collector_env_num=8, evaluator_env_num=5),
    policy=dict(
        type="muzero", env_type="board_games",
        model=dict(observation_shape=(9, 9, 3), action_space_size=82,
                   model_type="conv", downsample=False, num_channels=64, num_res_blocks=2,
                   support_scale=10),
        discount_factor=1.0, num_simulations=100, batch_size=256,
        update_per_collect=100, n_episode=8, eval_freq=200,
        manual_temperature_decay=True,
    ),
))
