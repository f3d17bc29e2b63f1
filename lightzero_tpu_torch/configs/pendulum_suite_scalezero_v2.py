"""ScaleZero 3-task suite v2: Sampled UniZero multitask over Pendulum with
g=10, g=14, and g=8 with torque 1.2 (embed 256, 8 heads, 22 tokens,
LayerNorm latents, K=20, 25 simulations, batch 96, unroll 10, LoRA r=4
over 2 stages).

The values of ``zoo/multitask/config/pendulum_suite_scalezero_v2_config.py``, copied so that the
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
        embed_dim=256,
        num_layers=2,
        num_heads=8,
        max_tokens=22,  # 2*K+2 >= the 21-token training window
        final_norm_option_in_encoder="LayerNorm",
        support_scale=100,
        num_tasks=3,
        lora_r=4,
        curriculum_stage_num=2,
    ),
    task_num=3,
    num_of_sampled_actions=20,
    num_simulations=25,
    batch_size=96,
    update_per_collect=100,
    n_episode=3,
    game_segment_length=50,
    eval_freq=40,
    num_unroll_steps=10,
    td_steps=5,
    discount_factor=0.99,
    learning_rate=1e-4,
    cos_lr_scheduler=True,
    cos_lr_decay_steps=int(5e4),
    manual_temperature_decay=True,
    threshold_training_steps_for_final_temperature=int(2.5e4),
    grad_clip_value=5.0,
    stage_solved_frac=0.6,
    use_adaptive_entropy_weight=False,
    policy_entropy_weight=5e-2,
    predict_latent_loss_type="mse",
    auto_resume=True,
    save_ckpt_freq=1200,
)

task_configs = [
    Config(dict(
        exp_name="data_mt/pendulum_suite_scalezero_v2_seed0",
        env=dict(type="pendulum", stop_value=-250, solved_threshold=-400,
                 collector_env_num=4, evaluator_env_num=2),
        policy=dict(_shared_policy),
    )),
    Config(dict(
        exp_name="data_mt/pendulum_suite_scalezero_v2_seed0",
        env=dict(type="pendulum", stop_value=-350, solved_threshold=-600,
                 env_kwargs=dict(gravity=14.0),
                 collector_env_num=4, evaluator_env_num=2),
        policy=dict(_shared_policy),
    )),
    Config(dict(
        exp_name="data_mt/pendulum_suite_scalezero_v2_seed0",
        env=dict(type="pendulum", stop_value=-350, solved_threshold=-600,
                 env_kwargs=dict(gravity=8.0, max_torque=1.2),
                 collector_env_num=4, evaluator_env_num=2),
        policy=dict(_shared_policy),
    )),
]
