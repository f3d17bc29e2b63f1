"""The values of
``zoo/classic_control/cartpole/config/cartpole_muzero_cont_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_muzero/cartpole_muzero_cont_seed0',
                      'env': {'env_id': 'CartPole-v0',
                              'stop_value': 200,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'model': {'observation_shape': 4,
                                           'action_space_size': 2,
                                           'model_type': 'mlp',
                                           'latent_state_dim': 128,
                                           'self_supervised_learning_loss': True,
                                           'discrete_action_encoding_type': 'one_hot',
                                           'norm_type': 'LN'},
                                 'env_type': 'not_board_games',
                                 'game_segment_length': 50,
                                 'update_per_collect': 100,
                                 'batch_size': 256,
                                 'optim_type': 'Adam',
                                 'piecewise_decay_lr_scheduler': False,
                                 'learning_rate': 0.003,
                                 'ssl_loss_weight': 2,
                                 'num_simulations': 25,
                                 'reanalyze_ratio': 0,
                                 'n_episode': 8,
                                 'eval_freq': 100,
                                 'replay_buffer_size': 1000000,
                                 'collector_env_num': 8,
                                 'evaluator_env_num': 3,
                                 'stop_consecutive_evals': 2}})
