"""The values of
``zoo/atari/config/atari_efficientzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_ez/pong_efficientzero_seed0',
                      'env': {'env_id': 'ALE/Pong-v5',
                              'stop_value': 20,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'efficientzero',
                                 'model': {'observation_shape': (96, 96, 12),
                                           'action_space_size': 6,
                                           'model_type': 'conv',
                                           'num_channels': 64,
                                           'lstm_hidden_size': 512},
                                 'frame_stack_num': 4,
                                 'num_simulations': 50,
                                 'batch_size': 256,
                                 'replay_ratio': 0.25,
                                 'n_episode': 8,
                                 'eval_freq': 2000,
                                 'lstm_horizon_len': 5,
                                 'optim_type': 'SGD',
                                 'learning_rate': 0.2,
                                 'piecewise_decay_lr_scheduler': True,
                                 'manual_temperature_decay': True}})
