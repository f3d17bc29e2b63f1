"""The values of
``zoo/atari/config/atari_muzero_rnn_fullobs_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_mz/pong_muzero_rnn_fullobs_seed0',
                      'env': {'env_id': 'ALE/Pong-v5',
                              'stop_value': 20,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'muzero_rnn_full_obs',
                                 'model': {'observation_shape': (96, 96, 12),
                                           'action_space_size': 6,
                                           'model_type': 'conv',
                                           'num_channels': 64,
                                           'num_res_blocks': 1,
                                           'downsample': True,
                                           'rnn_hidden_size': 512},
                                 'frame_stack_num': 4,
                                 'num_simulations': 50,
                                 'batch_size': 256,
                                 'replay_ratio': 0.25,
                                 'n_episode': 8,
                                 'eval_freq': 2000}})
