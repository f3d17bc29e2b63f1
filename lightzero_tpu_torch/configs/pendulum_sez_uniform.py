"""The values of
``zoo/classic_control/pendulum/config/pendulum_sez_uniform_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_sez/pendulum_sez_uniformprior_seed0',
                      'env': {'env_id': 'Pendulum-v1',
                              'stop_value': -250,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'sampled_efficientzero',
                                 'model': {'observation_shape': 3,
                                           'action_space_size': 1,
                                           'latent_state_dim': 128,
                                           'lstm_hidden_size': 128},
                                 'num_simulations': 50,
                                 'num_of_sampled_actions': 20,
                                 'batch_size': 256,
                                 'update_per_collect': None,
                                 'replay_ratio': 0.25,
                                 'n_episode': 8,
                                 'eval_freq': 200,
                                 'ssl_loss_weight': 2,
                                 'optim_type': 'AdamW',
                                 'learning_rate': 0.0001,
                                 'cos_lr_scheduler': True,
                                 'lstm_horizon_len': 5,
                                 'sampled_node_prior': 'uniform'}})
