"""Deep Sea (size 10) MuZero config: the values of
``zoo/bsuite/config/deep_sea_muzero_config.py``, copied so that the port
never loads the zoo file (it imports ``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

SIZE = 10

main_config = Config(dict(
    exp_name=f"data_bsuite/deep_sea{SIZE}_muzero_seed0",
    env=dict(type="deep_sea", size=SIZE, stop_value=0.99,
             collector_env_num=8, evaluator_env_num=3, n_evaluator_episode=3),
    policy=dict(
        type="muzero",
        model=dict(observation_shape=SIZE * SIZE, action_space_size=2,
                   model_type="mlp", latent_state_dim=128, support_scale=25,
                   self_supervised_learning_loss=True),
        ssl_loss_weight=2.0, num_simulations=25, batch_size=256,
        update_per_collect=100, n_episode=8, eval_freq=200,
        root_noise_weight=0.25, td_steps=5,
    ),
))
