"""The values of
``zoo/jericho/config/jericho_unizero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_uz/jericho_detective_unizero_seed0',
                      'env': {'env_id': 'jericho',
                              'stop_value': 1000000,
                              'collector_env_num': 4,
                              'evaluator_env_num': 2,
                              'env_kwargs': {'game_path': 'z-machine-games/jericho-game-suite/detective.z5',
                                             'max_action_num': 10,
                                             'max_seq_len': 512,
                                             'tokenizer_path': 'BAAI/bge-base-en-v1.5',
                                             'remove_stuck_actions': True}},
                      'policy': {'type': 'unizero',
                                 'model': {'observation_shape': 512,
                                           'action_space_size': 10,
                                           'obs_encoder': 'hf_language',
                                           'encoder_model': 'BAAI/bge-base-en-v1.5',
                                           'embed_dim': 768,
                                           'num_layers': 2,
                                           'num_heads': 8,
                                           'max_tokens': 20,
                                           'support_scale': 300},
                                 'num_simulations': 50,
                                 'num_unroll_steps': 10,
                                 'batch_size': 64,
                                 'update_per_collect': 100,
                                 'n_episode': 4,
                                 'eval_freq': 1000,
                                 'learning_rate': 0.0001}})
