"""Pendulum Sampled EfficientZero config, continuous actions: the values of
``zoo/classic_control/pendulum/config/pendulum_sampled_efficientzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).

What the zoo file leaves to the policy comes from
``SampledEfficientZeroPolicy.default_config()`` when the policy merges this
tree in: the Gaussian head's defaults, the uniform search prior, supports
of 601 atoms, the pUCT constants, ``reanalyze_ratio`` 0."""
from lightzero_tpu_torch.config import Config

K = 20  # num_of_sampled_actions

main_config = Config(dict(
    exp_name=f"data_sez/pendulum_sampled_efficientzero_k{K}_seed0",
    env=dict(env_id="Pendulum-v1", stop_value=-250, collector_env_num=8,
             evaluator_env_num=3, n_evaluator_episode=3),
    policy=dict(
        type="sampled_efficientzero",
        model=dict(observation_shape=3, action_space_size=1,
                   latent_state_dim=128, lstm_hidden_size=128),
        num_simulations=50, num_of_sampled_actions=K, batch_size=256,
        update_per_collect=None, replay_ratio=0.25, n_episode=8, eval_freq=200,
        ssl_loss_weight=2, optim_type="AdamW", learning_rate=1e-4,
        cos_lr_scheduler=True, lstm_horizon_len=5,
    ),
))
