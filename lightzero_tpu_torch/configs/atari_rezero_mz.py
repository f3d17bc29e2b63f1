"""The values of
``zoo/atari/config/atari_rezero_mz_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_rezero/pong_rezero_mz_seed0',
                      'env': {'env_id': 'ALE/Pong-v5',
                              'stop_value': 20,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'muzero',
                                 'model': {'observation_shape': (96, 96, 12),
                                           'action_space_size': 6,
                                           'model_type': 'conv',
                                           'num_channels': 64,
                                           'num_res_blocks': 1,
                                           'downsample': True,
                                           'self_supervised_learning_loss': True},
                                 'frame_stack_num': 4,
                                 'num_simulations': 50,
                                 'batch_size': 256,
                                 'replay_ratio': 0.25,
                                 'n_episode': 8,
                                 'eval_freq': 2000,
                                 'ssl_loss_weight': 2,
                                 'buffer_reanalyze_freq': 1.0,
                                 'reanalyze_batch_size': 160,
                                 'reanalyze_partition': 0.75,
                                 'reuse_search': True}})
