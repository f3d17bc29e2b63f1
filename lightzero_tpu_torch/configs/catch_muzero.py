"""Catch MuZero config: the values of ``zoo/bsuite/config/catch_muzero_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``). What the zoo file leaves to the policy comes from
``MuZeroPolicy.default_config()`` when the policy merges this tree in."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_bsuite/catch_muzero_seed0",
    env=dict(type="catch", rows=10, cols=5, stop_value=0.95,
             collector_env_num=8, evaluator_env_num=3, n_evaluator_episode=3),
    policy=dict(
        type="muzero",
        model=dict(observation_shape=50, action_space_size=3,
                   model_type="mlp", latent_state_dim=64, support_scale=25),
        num_simulations=25, batch_size=256, update_per_collect=50,
        n_episode=8, eval_freq=200, td_steps=5,
    ),
))
