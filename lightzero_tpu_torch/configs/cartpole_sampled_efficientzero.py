"""The values of
``zoo/classic_control/cartpole/config/cartpole_sampled_efficientzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_sez/cartpole_sampled_efficientzero_disc_seed0',
                      'env': {'type': 'cartpole',
                              'stop_value': 195,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'sampled_efficientzero',
                                 'model': {'observation_shape': 4,
                                           'action_space_size': 2,
                                           'continuous_action_space': False,
                                           'model_type': 'mlp',
                                           'latent_state_dim': 128,
                                           'lstm_hidden_size': 128},
                                 'num_of_sampled_actions': 2,
                                 'num_simulations': 25,
                                 'batch_size': 256,
                                 'update_per_collect': 100,
                                 'n_episode': 8,
                                 'eval_freq': 200}})
