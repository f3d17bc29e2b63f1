"""Grid Breakout UniZero, the warm-start online configuration: the values of
``zoo/breakout_grid/config/breakout_grid_unizero_ws_config.py``, copied so
that the port never loads the zoo file (it imports ``lightzero_tpu.config``).
Merged with ``UniZeroPolicy.default_config()`` it is the policy of the
committed run ``data_uz/breakout_grid_unizero_ws2_seed0/total_config.json``:
conv encoder of 64 channels without downsampling on (10, 10, 4) frames,
embed 256, 2 layers, 8 heads, 24 tokens, supports of 101 atoms, 25
simulations, batch 256, unroll 10, drift correction of depth 2 and the
``group_kl`` latent loss. (The zoo run warm-starts from an exported probe,
``model_path``; here that is the caller's to pass.)"""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_uz/breakout_grid_unizero_ws_seed0",
    env=dict(type="breakout_grid", stop_value=30,
             collector_env_num=8, evaluator_env_num=3),
    policy=dict(
        type="unizero",
        model=dict(observation_shape=(10, 10, 4), obs_type="image",
                   action_space_size=3, embed_dim=256, num_layers=2,
                   num_heads=8, max_tokens=24, context_window=0,
                   support_scale=50, num_channels=64, downsample=False),
        num_simulations=25, batch_size=256,
        update_per_collect=None, replay_ratio=0.1,
        train_start_after_envsteps=2000,
        n_episode=8, eval_freq=200, num_unroll_steps=10, td_steps=5,
        learning_rate=5e-4,
        drift_correction_weight=1.0,
        drift_correction_depth=2,
        use_adaptive_entropy_weight=False,
        policy_entropy_weight=5e-3,
        use_priority=False,
        manual_temperature_decay=False,
        fixed_temperature_value=0.25,
        predict_latent_loss_type="group_kl",
        auto_resume=True, save_ckpt_freq=2000,
    ),
))
