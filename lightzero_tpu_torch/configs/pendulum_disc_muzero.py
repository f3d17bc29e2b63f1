"""The values of
``zoo/classic_control/pendulum/config/pendulum_disc_muzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_mz/pendulum_disc_muzero_seed0',
                      'env': {'type': 'pendulum',
                              'stop_value': -250,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3,
                              'env_kwargs': {'discrete_bins': 11}},
                      'policy': {'type': 'muzero',
                                 'model': {'observation_shape': 3,
                                           'action_space_size': 11,
                                           'model_type': 'mlp',
                                           'latent_state_dim': 128},
                                 'num_simulations': 50,
                                 'batch_size': 256,
                                 'update_per_collect': 200,
                                 'n_episode': 8,
                                 'eval_freq': 200,
                                 'ssl_loss_weight': 2}})
