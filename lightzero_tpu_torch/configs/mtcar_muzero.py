"""The values of
``zoo/classic_control/mountain_car/config/mtcar_muzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_muzero/mtcar_muzero_seed0',
                      'env': {'env_id': 'MountainCar-v0',
                              'stop_value': -110,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'model': {'observation_shape': 2,
                                           'action_space_size': 3,
                                           'model_type': 'mlp',
                                           'latent_state_dim': 128,
                                           'self_supervised_learning_loss': True},
                                 'num_simulations': 25,
                                 'batch_size': 256,
                                 'update_per_collect': 100,
                                 'n_episode': 8,
                                 'eval_freq': 100,
                                 'ssl_loss_weight': 2}})
