"""The values of
``zoo/classic_control/pendulum/config/pendulum_cont_disc_unizero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_uz/pendulum_disc_unizero_seed0',
                      'env': {'type': 'pendulum',
                              'stop_value': -250,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3,
                              'env_kwargs': {'discrete_bins': 11}},
                      'policy': {'type': 'unizero',
                                 'model': {'observation_shape': 3,
                                           'action_space_size': 11,
                                           'embed_dim': 64,
                                           'num_layers': 2,
                                           'num_heads': 4,
                                           'max_tokens': 16,
                                           'support_scale': 100},
                                 'num_simulations': 25,
                                 'num_unroll_steps': 5,
                                 'batch_size': 256,
                                 'update_per_collect': 60,
                                 'n_episode': 8,
                                 'eval_freq': 200,
                                 'learning_rate': 0.001}})
