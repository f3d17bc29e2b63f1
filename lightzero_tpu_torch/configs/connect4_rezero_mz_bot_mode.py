"""Connect4 ReZero-MuZero against the rule bot (whole-buffer reanalyze and the
reuse search): the values of
``zoo/board_games/connect4/config/connect4_rezero_mz_bot_mode_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_rezero/connect4_rezero_mz_seed0",
    env=dict(type="connect4", battle_mode="play_with_bot_mode",
             stop_value=0.99,
             collector_env_num=8, evaluator_env_num=5, n_evaluator_episode=5),
    policy=dict(
        type="muzero", env_type="board_games",
        model=dict(observation_shape=(6, 7, 3), action_space_size=7,
                   model_type="conv", num_channels=64, num_res_blocks=1,
                   support_scale=1),
        num_simulations=50, batch_size=256, update_per_collect=50,
        n_episode=8, eval_freq=200, discount_factor=1.0, td_steps=42,
        buffer_reanalyze_freq=1.0, reanalyze_batch_size=160,
        reanalyze_partition=0.75, reuse_search=True,
    ),
))
