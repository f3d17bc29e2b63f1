"""The values of
``zoo/box2d/bipedalwalker/config/bipedalwalker_cont_sampled_muzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_smz/bipedalwalker_cont_smz_k20_seed0',
                      'env': {'env_id': 'BipedalWalker-v3',
                              'stop_value': 300,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3,
                              'n_evaluator_episode': 3},
                      'policy': {'type': 'sampled_muzero',
                                 'model': {'observation_shape': 24, 'action_space_size': 4, 'latent_state_dim': 256},
                                 'num_simulations': 50,
                                 'num_of_sampled_actions': 20,
                                 'batch_size': 256,
                                 'update_per_collect': 200,
                                 'n_episode': 8,
                                 'eval_freq': 500,
                                 'optim_type': 'AdamW',
                                 'learning_rate': 0.0001,
                                 'cos_lr_scheduler': True}})
