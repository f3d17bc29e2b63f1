"""The values of
``zoo/atari/config/atari_unizero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_uz/pong_unizero_seed0',
                      'env': {'env_id': 'ALE/Pong-v5',
                              'stop_value': 20,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'unizero',
                                 'model': {'observation_shape': (96, 96, 3),
                                           'obs_type': 'image',
                                           'action_space_size': 6,
                                           'embed_dim': 768,
                                           'num_layers': 2,
                                           'num_heads': 8,
                                           'max_tokens': 20,
                                           'num_channels': 64},
                                 'num_simulations': 50,
                                 'num_unroll_steps': 10,
                                 'batch_size': 64,
                                 'replay_ratio': 0.25,
                                 'n_episode': 8,
                                 'eval_freq': 2000,
                                 'learning_rate': 0.0001}})
