"""Two-task curriculum/balance UniZero: CartPole and bang-bang Pendulum
(observations zero-padded to 4 by ``pad_obs_to``, actions in 2 bins) share
one world model with a table of 2 task embeddings and CurriculumLoRA (r=4,
2 stages). The policy type is the plain ``unizero``, which binds no task: both
tasks train and search as task 0, as in the JAX package (ROADMAP queue 3).

The values of ``zoo/multitask/config/cartpole_pendulum_balance_config.py``, copied so that the
port never loads the zoo file (it imports ``lightzero_tpu.config``), as its
``task_configs`` list: one config per task, the first one's policy the
shared policy. Train it with ``entry.train_multitask_balance``."""
from lightzero_tpu_torch.config import Config

_shared_policy = dict(
    type="unizero",
    model=dict(observation_shape=4, action_space_size=2, embed_dim=64,
               num_layers=2, num_heads=4, max_tokens=16, support_scale=25,
               num_tasks=2, lora_r=4, curriculum_stage_num=2),
    num_simulations=25, batch_size=64, update_per_collect=60, n_episode=4,
    eval_freq=50, num_unroll_steps=5, td_steps=5, learning_rate=1e-3,
    stage_solved_frac=0.5,
)

task_configs = [
    Config(dict(
        exp_name="data_mt/balance_cartpole_pendulum_seed0",
        env=dict(type="cartpole", stop_value=195, solved_threshold=195,
                 collector_env_num=4, evaluator_env_num=2),
        policy=dict(_shared_policy),
    )),
    Config(dict(
        exp_name="data_mt/balance_cartpole_pendulum_seed0",
        env=dict(type="pendulum", stop_value=-300, solved_threshold=-400,
                 pad_obs_to=4, env_kwargs=dict(discrete_bins=2),
                 collector_env_num=4, evaluator_env_num=2),
        policy=dict(_shared_policy),
    )),
]
