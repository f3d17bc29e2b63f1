"""The values of
``zoo/dmc2gym/config/dmc2gym_state_smz_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_smz/dmc2gym_cartpole_swingup_state_smz_seed0',
                      'env': {'env_id': 'dmc2gym',
                              'stop_value': 1000000,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'env_kwargs': {'domain_name': 'cartpole',
                                             'task_name': 'swingup',
                                             'from_pixels': False}},
                      'policy': {'type': 'sampled_muzero',
                                 'model': {'observation_shape': 5,
                                           'action_space_size': 1,
                                           'continuous_action_space': True,
                                           'latent_state_dim': 256},
                                 'num_simulations': 50,
                                 'num_of_sampled_actions': 20,
                                 'batch_size': 256,
                                 'update_per_collect': 200,
                                 'n_episode': 8,
                                 'eval_freq': 1000}})
