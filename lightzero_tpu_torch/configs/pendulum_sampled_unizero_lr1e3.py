"""The values of
``zoo/classic_control/pendulum/config/pendulum_sampled_unizero_lr1e3_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_suz/pendulum_sampled_unizero_k16_lr1e3_seed0',
                      'env': {'type': 'pendulum',
                              'stop_value': -250,
                              'collector_env_num': 4,
                              'evaluator_env_num': 2},
                      'policy': {'type': 'sampled_unizero',
                                 'model': {'observation_shape': 3,
                                           'action_space_size': 1,
                                           'continuous_action_space': True,
                                           'embed_dim': 64,
                                           'num_layers': 2,
                                           'num_heads': 4,
                                           'max_tokens': 16,
                                           'support_scale': 100},
                                 'num_of_sampled_actions': 16,
                                 'num_simulations': 50,
                                 'batch_size': 192,
                                 'update_per_collect': 60,
                                 'n_episode': 4,
                                 'eval_freq': 40,
                                 'num_unroll_steps': 5,
                                 'td_steps': 5,
                                 'learning_rate': 0.001,
                                 'use_adaptive_entropy_weight': False,
                                 'policy_entropy_weight': 0.005,
                                 'auto_resume': True,
                                 'save_ckpt_freq': 2000}})
