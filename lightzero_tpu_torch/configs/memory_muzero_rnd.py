"""The values of
``zoo/memory/config/memory_muzero_rnd_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_mz/memory10_muzero_rnd_seed0',
                      'env': {'env_id': 'memory',
                              'stop_value': 0.95,
                              'collector_env_num': 8,
                              'evaluator_env_num': 4,
                              'n_evaluator_episode': 8,
                              'env_kwargs': {'num_cues': 4, 'memory_length': 10}},
                      'policy': {'type': 'muzero',
                                 'model': {'observation_shape': 8,
                                           'action_space_size': 4,
                                           'model_type': 'mlp',
                                           'latent_state_dim': 128,
                                           'support_scale': 5},
                                 'num_simulations': 50,
                                 'num_unroll_steps': 12,
                                 'td_steps': 12,
                                 'batch_size': 256,
                                 'update_per_collect': 100,
                                 'n_episode': 8,
                                 'eval_freq': 150,
                                 'discount_factor': 1.0,
                                 'ssl_loss_weight': 2},
                      'reward_model': {'type': 'rnd',
                                       'intrinsic_reward_weight': 0.003,
                                       'input_type': 'obs',
                                       'hidden_dim': 256}})
