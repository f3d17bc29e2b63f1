"""Memory env UniZero config (the long-context probe): the values of
``zoo/memory/config/memory_unizero_config.py``, copied so that the port never
loads the zoo file (it imports ``lightzero_tpu.config``): memory length 10,
the whole episode in the context (28 tokens) and in each training
sequence."""
from lightzero_tpu_torch.config import Config

memory_length = 10

main_config = Config(dict(
    exp_name=f"data_uz/memory{memory_length}_unizero_seed0",
    env=dict(env_id="memory", stop_value=0.95,
             collector_env_num=8, evaluator_env_num=4, n_evaluator_episode=8,
             env_kwargs=dict(num_cues=4, memory_length=memory_length)),
    policy=dict(
        type="unizero",
        model=dict(observation_shape=3 + 4 + 1, action_space_size=4,
                   embed_dim=64, num_layers=2, num_heads=4,
                   max_tokens=2 * (memory_length + 4),
                   support_scale=5),
        num_simulations=15,
        num_unroll_steps=memory_length + 2,
        td_steps=memory_length + 2,
        batch_size=64, update_per_collect=50, n_episode=8,
        eval_freq=150, learning_rate=0.001, discount_factor=1.0,
    ),
))
