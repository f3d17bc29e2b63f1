"""The values of
``zoo/metadrive/config/metadrive_sampled_efficientzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_sez/metadrive_sez_K20_seed0',
                      'env': {'env_id': 'metadrive',
                              'stop_value': 1000000,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'env_kwargs': {'env_config': {'traffic_density': 0.1}}},
                      'policy': {'type': 'sampled_efficientzero',
                                 'model': {'observation_shape': 259,
                                           'action_space_size': 2,
                                           'continuous_action_space': True,
                                           'latent_state_dim': 256,
                                           'lstm_hidden_size': 256},
                                 'num_simulations': 50,
                                 'num_of_sampled_actions': 20,
                                 'batch_size': 256,
                                 'update_per_collect': 200,
                                 'n_episode': 8,
                                 'eval_freq': 1000}})
