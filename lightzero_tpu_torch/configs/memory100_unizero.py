"""The values of
``zoo/memory/config/memory100_unizero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_uz/memory100_unizero_seed0',
                      'env': {'env_id': 'memory',
                              'stop_value': 0.95,
                              'collector_env_num': 8,
                              'evaluator_env_num': 4,
                              'n_evaluator_episode': 8,
                              'env_kwargs': {'num_cues': 4, 'memory_length': 100}},
                      'policy': {'type': 'unizero',
                                 'model': {'observation_shape': 8,
                                           'action_space_size': 4,
                                           'embed_dim': 96,
                                           'num_layers': 2,
                                           'num_heads': 4,
                                           'max_tokens': 212,
                                           'support_scale': 5},
                                 'num_simulations': 15,
                                 'num_unroll_steps': 102,
                                 'td_steps': 102,
                                 'batch_size': 32,
                                 'update_per_collect': 50,
                                 'n_episode': 8,
                                 'eval_freq': 150,
                                 'learning_rate': 0.001,
                                 'discount_factor': 1.0}})
