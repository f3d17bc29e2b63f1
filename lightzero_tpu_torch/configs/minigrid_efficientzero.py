"""The values of
``zoo/minigrid/config/minigrid_efficientzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_sez/minigrid_empty8_efficientzero_seed0',
                      'env': {'env_id': 'MiniGrid-Empty-8x8-v0',
                              'stop_value': 0.96,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'efficientzero',
                                 'model': {'observation_shape': 2835,
                                           'action_space_size': 7,
                                           'model_type': 'mlp',
                                           'latent_state_dim': 256},
                                 'num_simulations': 50,
                                 'batch_size': 256,
                                 'update_per_collect': 200,
                                 'n_episode': 8,
                                 'eval_freq': 1000}})
