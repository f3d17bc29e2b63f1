"""Grid Breakout UniZero config (conv tokenizer and decoder): the values of
``zoo/breakout_grid/config/breakout_grid_unizero_config.py``, copied so that
the port never loads the zoo file (it imports ``lightzero_tpu.config``).
``latent_recon_loss_weight`` 0.05 builds the decoder; the rest comes from
``UniZeroPolicy.default_config()``."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_uz/breakout_grid_unizero_seed0",
    env=dict(type="breakout_grid", stop_value=30,
             collector_env_num=8, evaluator_env_num=3),
    policy=dict(
        type="unizero",
        model=dict(observation_shape=(10, 10, 4), obs_type="image",
                   action_space_size=3, embed_dim=128, num_layers=2,
                   num_heads=8, max_tokens=20, support_scale=50,
                   num_channels=32, downsample=False),
        latent_recon_loss_weight=0.05,
        num_simulations=25, batch_size=64, update_per_collect=100,
        n_episode=8, eval_freq=200, num_unroll_steps=10, td_steps=5,
    ),
))
