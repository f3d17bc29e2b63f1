"""The values of
``zoo/box2d/lunarlander/config/lunarlander_disc_sampled_unizero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_suz/lunarlander_disc_sampled_unizero_seed0',
                      'env': {'type': 'lunarlander',
                              'stop_value': 200,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'sampled_unizero',
                                 'model': {'observation_shape': 8,
                                           'action_space_size': 4,
                                           'continuous_action_space': False,
                                           'embed_dim': 256,
                                           'num_layers': 2,
                                           'num_heads': 8,
                                           'max_tokens': 22,
                                           'final_norm_option_in_encoder': 'LayerNorm',
                                           'support_scale': 300},
                                 'num_of_sampled_actions': 3,
                                 'num_simulations': 25,
                                 'batch_size': 64,
                                 'update_per_collect': 100,
                                 'n_episode': 8,
                                 'game_segment_length': 50,
                                 'num_unroll_steps': 10,
                                 'td_steps': 5,
                                 'discount_factor': 0.99,
                                 'learning_rate': 0.0001,
                                 'grad_clip_value': 5.0,
                                 'use_adaptive_entropy_weight': False,
                                 'policy_entropy_weight': 0.05,
                                 'eval_freq': 500}})
