"""The values of
``zoo/pooltool/config/sum_to_three_vector_obs_sez_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_sez/sum_to_three_vector_sez_seed0',
                      'env': {'env_id': 'sum_to_three',
                              'stop_value': 1000000,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'env_kwargs': {'episode_length': 10}},
                      'policy': {'type': 'sampled_efficientzero',
                                 'model': {'observation_shape': 4,
                                           'action_space_size': 2,
                                           'continuous_action_space': True,
                                           'latent_state_dim': 128,
                                           'lstm_hidden_size': 128},
                                 'num_simulations': 50,
                                 'num_of_sampled_actions': 20,
                                 'batch_size': 256,
                                 'update_per_collect': 100,
                                 'n_episode': 8,
                                 'eval_freq': 1000,
                                 'discount_factor': 1.0}})
