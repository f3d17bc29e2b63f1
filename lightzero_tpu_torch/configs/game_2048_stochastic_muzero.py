"""2048 Stochastic MuZero config, with true chance labels: the values of
``zoo/game_2048/config/stochastic_muzero_2048_config.py``, copied so that the
port never loads the zoo file (it imports ``lightzero_tpu.config``).

What the zoo file leaves to the policy (the MLP model, the optimizer, the
search constants, ``reanalyze_ratio`` 0) comes from
``StochasticMuZeroPolicy.default_config()`` when the policy merges this tree
in."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_stoch/game_2048_stochastic_muzero_seed0",
    env=dict(env_id="game_2048", stop_value=int(1e9), collector_env_num=8,
             evaluator_env_num=3, n_evaluator_episode=3),
    policy=dict(
        type="stochastic_muzero",
        model=dict(observation_shape=4 * 4 * 16, action_space_size=4,
                   chance_space_size=32, latent_state_dim=256, support_scale=300),
        num_simulations=50, batch_size=256, update_per_collect=100, n_episode=8,
        eval_freq=200, use_ture_chance_label_in_chance_encoder=True,
    ),
))
