"""Deep Sea (size 8) EfficientZero config: the values of
``zoo/bsuite/config/bsuite_efficientzero_config.py``, copied so that the
port never loads the zoo file (it imports ``lightzero_tpu.config``)."""
from lightzero_tpu_torch.config import Config

size = 8

main_config = Config(dict(
    exp_name=f"data_sez/deep_sea{size}_efficientzero_seed0",
    env=dict(env_id="deep_sea", stop_value=0.99,
             collector_env_num=8, evaluator_env_num=4, n_evaluator_episode=8,
             env_kwargs=dict(size=size)),
    policy=dict(
        type="efficientzero",
        model=dict(observation_shape=size * size, action_space_size=2,
                   model_type="mlp", latent_state_dim=128, support_scale=5),
        num_simulations=50, batch_size=256, update_per_collect=100,
        n_episode=8, eval_freq=150, discount_factor=1.0,
    ),
))
