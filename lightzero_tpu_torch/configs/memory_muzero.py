"""Memory env (memory length 10) MuZero config: the values of
``zoo/memory/config/memory_muzero_config.py``, copied so that the port never
loads the zoo file (it imports ``lightzero_tpu.config``). The unroll spans
the whole episode, so the dynamics must carry the cue."""
from lightzero_tpu_torch.config import Config

memory_length = 10

main_config = Config(dict(
    exp_name=f"data_mz/memory{memory_length}_muzero_seed0",
    env=dict(env_id="memory", stop_value=0.95,
             collector_env_num=8, evaluator_env_num=4, n_evaluator_episode=8,
             env_kwargs=dict(num_cues=4, memory_length=memory_length)),
    policy=dict(
        type="muzero",
        model=dict(observation_shape=3 + 4 + 1, action_space_size=4,
                   model_type="mlp", latent_state_dim=128, support_scale=5),
        num_simulations=50,
        num_unroll_steps=memory_length + 2,
        td_steps=memory_length + 2,
        batch_size=256, update_per_collect=100, n_episode=8,
        eval_freq=150, discount_factor=1.0, ssl_loss_weight=2,
    ),
))
