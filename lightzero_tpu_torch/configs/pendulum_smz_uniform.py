"""The values of
``zoo/classic_control/pendulum/config/pendulum_smz_uniform_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_smz/pendulum_smz_uniformprior_seed0',
                      'env': {'env_id': 'Pendulum-v1',
                              'stop_value': -250,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'sampled_muzero',
                                 'model': {'observation_shape': 3,
                                           'action_space_size': 1,
                                           'model_type': 'mlp',
                                           'latent_state_dim': 128,
                                           'support_scale': 300,
                                           'self_supervised_learning_loss': True,
                                           'norm_type': 'LN',
                                           'continuous_action_space': True},
                                 'batch_size': 256,
                                 'optim_type': 'AdamW',
                                 'learning_rate': 0.0001,
                                 'num_unroll_steps': 5,
                                 'td_steps': 5,
                                 'discount_factor': 0.997,
                                 'num_simulations': 50,
                                 'num_of_sampled_actions': 20,
                                 'sampled_node_prior': 'uniform',
                                 'ssl_loss_weight': 2,
                                 'policy_entropy_weight': 0.005,
                                 'eval_freq': 200,
                                 'replay_ratio': 0.25,
                                 'n_episode': 8,
                                 'game_segment_length': 200,
                                 'cos_lr_scheduler': True,
                                 'grad_clip_value': 10.0}})
