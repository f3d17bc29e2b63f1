"""Connect4 MuZero against the rule bot, the continuation run: the values of
``zoo/board_games/connect4/config/connect4_muzero_resume_config.py``, copied
so that the port never loads the zoo file (it imports
``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_mz/connect4_muzero_ns50_seed0_cont",
    env=dict(type="connect4", battle_mode="play_with_bot_mode", stop_value=0.99,
             collector_env_num=8, evaluator_env_num=5),
    policy=dict(
        type="muzero", env_type="board_games",
        model=dict(observation_shape=(6, 7, 3), action_space_size=7,
                   model_type="conv", num_channels=64, num_res_blocks=1,
                   downsample=False,
                   support_scale=10),
        td_steps=21, discount_factor=1.0, num_simulations=50, batch_size=256,
        update_per_collect=50, n_episode=8, eval_freq=2000,
        learning_rate=0.003, grad_clip_value=0.5,
        auto_resume=True, save_ckpt_freq=3000,
    ),
))
