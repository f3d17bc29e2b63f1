"""CartPole UniZero config: the values of
``zoo/classic_control/cartpole/config/cartpole_unizero_config.py``, copied so
that the port never loads the zoo file (it imports ``lightzero_tpu.config``).
What the zoo file leaves to the policy comes from
``UniZeroPolicy.default_config()`` when the policy merges this tree in:
SimNorm latents with the MSE latent loss, the adaptive entropy, AdamW with
the selective decay, supports of 51 atoms (``support_scale`` 25)."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_uz/cartpole_unizero_seed0",
    env=dict(env_id="CartPole-v0", stop_value=195, collector_env_num=8,
             evaluator_env_num=3, n_evaluator_episode=3),
    policy=dict(
        type="unizero",
        model=dict(observation_shape=4, action_space_size=2, embed_dim=64,
                   num_layers=2, num_heads=4, max_tokens=16, support_scale=25),
        num_simulations=25, num_unroll_steps=5, batch_size=64,
        update_per_collect=60, n_episode=8, eval_freq=100, learning_rate=0.001,
    ),
))
