"""The values of
``zoo/dmc2gym/config/dmc2gym_state_suz_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_suz/dmc2gym_cartpole_swingup_state_suz_seed0',
                      'env': {'env_id': 'dmc2gym',
                              'stop_value': 1000000,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'env_kwargs': {'domain_name': 'cartpole',
                                             'task_name': 'swingup',
                                             'from_pixels': False}},
                      'policy': {'type': 'sampled_unizero',
                                 'model': {'observation_shape': 5,
                                           'action_space_size': 1,
                                           'continuous_action_space': True,
                                           'embed_dim': 128,
                                           'num_layers': 2,
                                           'num_heads': 4,
                                           'max_tokens': 16,
                                           'support_scale': 100},
                                 'num_simulations': 50,
                                 'num_of_sampled_actions': 20,
                                 'batch_size': 64,
                                 'update_per_collect': 60,
                                 'n_episode': 8,
                                 'eval_freq': 1000,
                                 'learning_rate': 0.001}})
