"""The values of
``zoo/box2d/bipedalwalker/config/bipedalwalker_cont_sampled_unizero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_suz/bipedalwalker_cont_suz_seed0',
                      'env': {'env_id': 'BipedalWalker-v3',
                              'stop_value': 300,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'sampled_unizero',
                                 'model': {'observation_shape': 24,
                                           'action_space_size': 4,
                                           'continuous_action_space': True,
                                           'embed_dim': 128,
                                           'num_layers': 2,
                                           'num_heads': 4,
                                           'max_tokens': 16,
                                           'support_scale': 300},
                                 'num_simulations': 50,
                                 'num_of_sampled_actions': 20,
                                 'batch_size': 64,
                                 'update_per_collect': 60,
                                 'n_episode': 8,
                                 'eval_freq': 200,
                                 'learning_rate': 0.001}})
