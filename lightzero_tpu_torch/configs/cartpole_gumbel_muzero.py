"""CartPole Gumbel MuZero config, a low simulation budget: the values of
``zoo/classic_control/cartpole/config/cartpole_gumbel_muzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).

What the zoo file leaves to the policy comes from
``GumbelMuZeroPolicy.default_config()`` when the policy merges this tree
in."""
from lightzero_tpu_torch.config import Config

max_env_step = int(1e5)

main_config = Config(dict(
    exp_name="data_gmz/cartpole_gumbel_muzero_ns10_seed0",
    env=dict(env_id="CartPole-v0", stop_value=195, collector_env_num=8,
             evaluator_env_num=3, n_evaluator_episode=3),
    policy=dict(
        type="gumbel_muzero",
        model=dict(observation_shape=4, action_space_size=2, model_type="mlp",
                   latent_state_dim=128, self_supervised_learning_loss=True),
        num_simulations=10, max_num_considered_actions=2, batch_size=256,
        update_per_collect=100, n_episode=8, eval_freq=100, ssl_loss_weight=2,
    ),
))
