"""The values of
``zoo/breakout_grid/config/breakout_grid_unizero_v3_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_uz/breakout_grid_unizero_v3_seed0',
                      'env': {'type': 'breakout_grid',
                              'stop_value': 30,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3},
                      'policy': {'type': 'unizero',
                                 'model': {'observation_shape': (10, 10, 4),
                                           'obs_type': 'image',
                                           'action_space_size': 3,
                                           'embed_dim': 256,
                                           'num_layers': 2,
                                           'num_heads': 8,
                                           'max_tokens': 24,
                                           'support_scale': 50,
                                           'num_channels': 64,
                                           'downsample': False},
                                 'num_simulations': 50,
                                 'batch_size': 256,
                                 'update_per_collect': 100,
                                 'n_episode': 8,
                                 'eval_freq': 200,
                                 'num_unroll_steps': 10,
                                 'td_steps': 5,
                                 'learning_rate': 0.0005,
                                 'use_adaptive_entropy_weight': False,
                                 'policy_entropy_weight': 0.005,
                                 'predict_latent_loss_type': 'group_kl',
                                 'manual_temperature_decay': True,
                                 'threshold_training_steps_for_final_temperature': 25000,
                                 'auto_resume': True,
                                 'save_ckpt_freq': 2000}})
