"""The values of
``zoo/game_2048/config/stochastic_muzero_2048_v2_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_stoch/game_2048_smz_v2_seed0',
                      'env': {'env_id': 'game_2048',
                              'stop_value': 1000000000,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'stochastic_muzero',
                                 'model': {'observation_shape': 256,
                                           'action_space_size': 4,
                                           'chance_space_size': 32,
                                           'latent_state_dim': 512,
                                           'support_scale': 300},
                                 'num_simulations': 100,
                                 'batch_size': 256,
                                 'update_per_collect': 100,
                                 'n_episode': 8,
                                 'td_steps': 10,
                                 'discount_factor': 0.999,
                                 'manual_temperature_decay': True,
                                 'threshold_training_steps_for_final_temperature': 100000,
                                 'eval_freq': 200,
                                 'use_ture_chance_label_in_chance_encoder': True,
                                 'auto_resume': True,
                                 'save_ckpt_freq': 3000}})
