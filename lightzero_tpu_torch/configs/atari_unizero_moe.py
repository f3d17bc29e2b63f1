"""The values of
``zoo/atari/config/atari_unizero_moe_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).
"""
from lightzero_tpu_torch.config import Config

main_config = Config({'exp_name': 'data_uz/atari_pong_unizero_moe_seed0',
                      'env': {'type': 'atari',
                              'env_id': 'PongNoFrameskip-v4',
                              'stop_value': 20,
                              'collector_env_num': 8,
                              'evaluator_env_num': 3},
                      'policy': {'type': 'unizero',
                                 'model': {'observation_shape': (64, 64, 3),
                                           'obs_type': 'image',
                                           'action_space_size': 6,
                                           'embed_dim': 256,
                                           'num_layers': 2,
                                           'num_heads': 8,
                                           'max_tokens': 20,
                                           'support_scale': 300,
                                           'moe_in_transformer': True,
                                           'num_experts': 4,
                                           'num_experts_per_tok': 1,
                                           'encoder_type': 'conv'},
                                 'num_simulations': 50,
                                 'batch_size': 64,
                                 'update_per_collect': 200,
                                 'n_episode': 8,
                                 'eval_freq': 500,
                                 'num_unroll_steps': 10,
                                 'td_steps': 5,
                                 'latent_recon_loss_weight': 0.1}})
