"""Pendulum Sampled UniZero config, continuous actions: the values of
``zoo/classic_control/pendulum/config/pendulum_sampled_unizero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``): K=16 sampled actions, 50 simulations, supports of
201 atoms (``support_scale`` 100), AdamW at 1e-4, a fixed entropy weight.
What it leaves to the policy comes from
``SampledUniZeroPolicy.default_config()``."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_suz/pendulum_sampled_unizero_k16_seed0",
    env=dict(type="pendulum", stop_value=-250,
             collector_env_num=4, evaluator_env_num=2),
    policy=dict(
        type="sampled_unizero",
        model=dict(
            observation_shape=3,
            action_space_size=1,
            continuous_action_space=True,
            embed_dim=64,
            num_layers=2,
            num_heads=4,
            max_tokens=16,
            support_scale=100,
        ),
        num_of_sampled_actions=16,
        num_simulations=50,
        batch_size=192,
        update_per_collect=60,
        n_episode=4,
        eval_freq=40,
        num_unroll_steps=5,
        td_steps=5,
        learning_rate=1e-4,
        use_adaptive_entropy_weight=False,
        policy_entropy_weight=5e-3,
    ),
))
