"""CartPole EfficientZero config: the values of
``zoo/classic_control/cartpole/config/cartpole_efficientzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).

What the zoo file leaves to the policy comes from
``EfficientZeroPolicy.default_config()`` when the policy merges this tree
in: SSL on with weight 2, supports of 601 atoms, the pUCT constants."""
from lightzero_tpu_torch.config import Config

num_simulations = 25
max_env_step = int(1e5)

main_config = Config(dict(
    exp_name=f"data_ez/cartpole_efficientzero_ns{num_simulations}_seed0",
    env=dict(env_id="CartPole-v0", stop_value=195, collector_env_num=8,
             evaluator_env_num=3, n_evaluator_episode=3),
    policy=dict(
        type="efficientzero",
        model=dict(observation_shape=4, action_space_size=2, model_type="mlp",
                   latent_state_dim=128, lstm_hidden_size=128),
        num_simulations=num_simulations, batch_size=256, update_per_collect=100,
        n_episode=8, eval_freq=100, learning_rate=0.003, lstm_horizon_len=5,
    ),
))
