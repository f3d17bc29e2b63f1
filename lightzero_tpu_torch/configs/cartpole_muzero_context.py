"""CartPole MuZero-Context config: the values of
``zoo/classic_control/cartpole/config/cartpole_muzero_context_config.py``,
copied so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).

MuZero trained as usual, whose collect and eval searches start from the
root latent rolled through the dynamics network, encoded again at an
episode's start and every ``context_length_init`` steps. What the zoo file
leaves to the policy comes from ``MuZeroContextPolicy.default_config()``."""
from lightzero_tpu_torch.config import Config

collector_env_num = 8
n_episode = 8
evaluator_env_num = 3
num_simulations = 25
update_per_collect = 100
batch_size = 256
max_env_step = int(1e5)
context_length_init = 5

cartpole_muzero_context_config = Config(
    dict(
        exp_name=f"data_muzero/cartpole_muzero_context_ns{num_simulations}_ctx{context_length_init}_seed0",
        env=dict(
            env_id="CartPole-v0",
            stop_value=195,
            collector_env_num=collector_env_num,
            evaluator_env_num=evaluator_env_num,
            n_evaluator_episode=evaluator_env_num,
        ),
        policy=dict(
            type="muzero_context",
            model=dict(
                observation_shape=4,
                action_space_size=2,
                model_type="mlp",
                latent_state_dim=128,
                self_supervised_learning_loss=True,
                discrete_action_encoding_type="one_hot",
                norm_type="LN",
            ),
            env_type="not_board_games",
            game_segment_length=50,
            context_length_init=context_length_init,
            update_per_collect=update_per_collect,
            batch_size=batch_size,
            optim_type="Adam",
            piecewise_decay_lr_scheduler=False,
            learning_rate=0.003,
            ssl_loss_weight=2,
            num_simulations=num_simulations,
            n_episode=n_episode,
            eval_freq=100,
            replay_buffer_size=int(1e6),
            collector_env_num=collector_env_num,
            evaluator_env_num=evaluator_env_num,
        ),
    )
)
main_config = cartpole_muzero_context_config
