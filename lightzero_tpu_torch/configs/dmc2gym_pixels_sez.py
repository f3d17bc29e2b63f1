"""The values of
``zoo/dmc2gym/config/dmc2gym_pixels_sez_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_sez/dmc2gym_cartpole_swingup_pixels_sez_seed0',
                      'env': {'env_id': 'dmc2gym',
                              'stop_value': 1000000,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'env_kwargs': {'domain_name': 'cartpole',
                                             'task_name': 'swingup',
                                             'from_pixels': True,
                                             'height': 84,
                                             'width': 84}},
                      'policy': {'type': 'sampled_efficientzero',
                                 'model': {'observation_shape': (84, 84, 3),
                                           'action_space_size': 1,
                                           'continuous_action_space': True,
                                           'model_type': 'conv',
                                           'num_channels': 64,
                                           'num_res_blocks': 1,
                                           'downsample': True,
                                           'lstm_hidden_size': 256},
                                 'num_simulations': 50,
                                 'num_of_sampled_actions': 20,
                                 'batch_size': 256,
                                 'update_per_collect': 200,
                                 'n_episode': 8,
                                 'eval_freq': 1000}})
