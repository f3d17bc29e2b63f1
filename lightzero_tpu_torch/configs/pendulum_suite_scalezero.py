"""ScaleZero 3-task suite v1: Sampled UniZero multitask over Pendulum with
g=10, g=14, and g=8 with torque 1.2 (embed 64, K=16, 50 simulations,
batch 192, LoRA r=4 over 2 stages).

The values of ``zoo/multitask/config/pendulum_suite_scalezero_config.py``, copied so that the
port never loads the zoo file (it imports ``lightzero_tpu.config``), as its
``task_configs`` list: one config per task, the first one's policy the
shared policy. Train it with ``entry.train_multitask_balance``."""
from lightzero_tpu_torch.config import Config

_shared_policy = dict(
    type="sampled_unizero_multitask",
    model=dict(
        observation_shape=3,
        action_space_size=1,  # continuous action dim
        continuous_action_space=True,
        embed_dim=64,
        num_layers=2,
        num_heads=4,
        max_tokens=16,
        # pendulum n-step value targets reach h(-2800) ~ -54: scale 25 CLIPS
        # them (kills value learning — this exact failure was observed on the
        # first suite run; docs/tutorial.md support_scale warning)
        support_scale=100,
        num_tasks=3,
        lora_r=4,
        curriculum_stage_num=2,
    ),
    task_num=3,
    # full search scale: a sims-12/K-6 shrink left BOTH sampled_unizero and
    # the known-good sampled_muzero flat on pendulum (CPU isolation runs) —
    # swing-up needs the reference-scale sampled search
    num_of_sampled_actions=16,
    num_simulations=50,
    batch_size=192,
    update_per_collect=60,
    n_episode=3,
    eval_freq=40,
    num_unroll_steps=5,
    td_steps=5,
    # lr 1e-4 ("UniZero AdamW convention") left the mu-head effectively at
    # init on pendulum — the single-task isolation run solved the env at
    # 1e-3 (eval -124 at 24k steps, data_suz/..._lr1e3_seed0, round 4)
    learning_rate=1e-3,
    stage_solved_frac=0.6,
    use_adaptive_entropy_weight=False,
    policy_entropy_weight=5e-3,
    auto_resume=True,
    save_ckpt_freq=1200,
)

task_configs = [
    Config(dict(
        exp_name="data_mt/pendulum_suite_scalezero_seed0",
        env=dict(type="pendulum", stop_value=-250, solved_threshold=-400,
                 collector_env_num=4, evaluator_env_num=2),
        policy=dict(_shared_policy),
    )),
    Config(dict(
        exp_name="data_mt/pendulum_suite_scalezero_seed0",
        env=dict(type="pendulum", stop_value=-350, solved_threshold=-600,
                 env_kwargs=dict(gravity=14.0),
                 collector_env_num=4, evaluator_env_num=2),
        policy=dict(_shared_policy),
    )),
    Config(dict(
        exp_name="data_mt/pendulum_suite_scalezero_seed0",
        env=dict(type="pendulum", stop_value=-350, solved_threshold=-600,
                 env_kwargs=dict(gravity=8.0, max_torque=1.2),
                 collector_env_num=4, evaluator_env_num=2),
        policy=dict(_shared_policy),
    )),
]
