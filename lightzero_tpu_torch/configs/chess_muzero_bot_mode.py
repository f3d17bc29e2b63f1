"""Chess MuZero against the rule bot: the values of
``zoo/board_games/chess/config/chess_muzero_bot_mode_config.py``, copied so
that the port never loads the zoo file (it imports
``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_mz/chess_muzero_ns50_seed0",
    env=dict(type="chess", battle_mode="play_with_bot_mode", stop_value=0.95,
             collector_env_num=8, evaluator_env_num=5, n_evaluator_episode=10),
    policy=dict(
        type="muzero",
        model=dict(observation_shape=(8, 8, 20), action_space_size=4672,
                   model_type="conv", downsample=False, num_channels=96, num_res_blocks=6,
                   support_scale=25),
        num_simulations=50, batch_size=256, update_per_collect=100, n_episode=8,
        eval_freq=500, td_steps=5, num_unroll_steps=5,
        manual_temperature_decay=True,
        threshold_training_steps_for_final_temperature=int(1e5),
    ),
))
