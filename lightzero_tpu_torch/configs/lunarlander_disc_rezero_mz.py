"""The values of
``zoo/box2d/lunarlander/config/lunarlander_disc_rezero_mz_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_rezero/lunarlander_disc_rezero_mz_seed0',
                      'env': {'env_id': 'LunarLander-v3',
                              'stop_value': 240,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'muzero',
                                 'model': {'observation_shape': 8,
                                           'action_space_size': 4,
                                           'model_type': 'mlp',
                                           'latent_state_dim': 256,
                                           'self_supervised_learning_loss': True},
                                 'num_simulations': 50,
                                 'batch_size': 256,
                                 'update_per_collect': 100,
                                 'n_episode': 8,
                                 'eval_freq': 200,
                                 'ssl_loss_weight': 2,
                                 'buffer_reanalyze_freq': 1.0,
                                 'reanalyze_batch_size': 160,
                                 'reanalyze_partition': 0.75,
                                 'reuse_search': True}})
