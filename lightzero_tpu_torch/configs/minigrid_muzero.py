"""The values of
``zoo/minigrid/config/minigrid_muzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_mz/MiniGrid-Empty-8x8-v0_muzero_ns50_seed0',
                      'env': {'env_id': 'MiniGrid-Empty-8x8-v0',
                              'stop_value': 0.96,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'env_kwargs': {'max_step': 300}},
                      'policy': {'type': 'muzero',
                                 'model': {'observation_shape': 2835,
                                           'action_space_size': 7,
                                           'model_type': 'mlp',
                                           'latent_state_dim': 512,
                                           'self_supervised_learning_loss': True},
                                 'num_simulations': 50,
                                 'td_steps': 5,
                                 'discount_factor': 0.997,
                                 'batch_size': 256,
                                 'update_per_collect': 200,
                                 'n_episode': 8,
                                 'eval_freq': 1000,
                                 'ssl_loss_weight': 2,
                                 'learning_rate': 0.003}})
