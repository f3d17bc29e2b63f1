"""Asterix-grid MuZero (conv, SSL) config: the values of
``zoo/minatar/config/asterix_muzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``). What the zoo file leaves to the policy comes from
``MuZeroPolicy.default_config()`` when the policy merges this tree in: its
supports have 101 atoms (``support_scale`` 50)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_mz/asterix_grid_muzero_seed0",
    env=dict(type="asterix_grid", stop_value=15,
             collector_env_num=8, evaluator_env_num=3),
    policy=dict(
        type="muzero",
        model=dict(observation_shape=(10, 10, 4), action_space_size=5,
                   model_type="conv", num_channels=32, num_res_blocks=1,
                   downsample=False, support_scale=50,
                   self_supervised_learning_loss=True),
        ssl_loss_weight=2.0,
        num_simulations=25, batch_size=256, update_per_collect=100,
        n_episode=8, eval_freq=200, manual_temperature_decay=True,
        threshold_training_steps_for_final_temperature=int(5e4),
    ),
))
