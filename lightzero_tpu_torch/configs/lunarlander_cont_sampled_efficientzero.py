"""The values of
``zoo/box2d/lunarlander/config/lunarlander_cont_sampled_efficientzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_sez/lunarlander_cont_sez_k20_seed0',
                      'env': {'env_id': 'LunarLanderContinuous-v3',
                              'stop_value': 240,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'sampled_efficientzero',
                                 'model': {'observation_shape': 8,
                                           'action_space_size': 2,
                                           'latent_state_dim': 256,
                                           'lstm_hidden_size': 256},
                                 'num_simulations': 50,
                                 'num_of_sampled_actions': 20,
                                 'batch_size': 256,
                                 'update_per_collect': 200,
                                 'n_episode': 8,
                                 'eval_freq': 500,
                                 'ssl_loss_weight': 2,
                                 'optim_type': 'AdamW',
                                 'learning_rate': 0.0001,
                                 'cos_lr_scheduler': True,
                                 'lstm_horizon_len': 5}})
