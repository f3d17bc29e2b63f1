"""CartPole ReZero-MuZero config: the values of
``zoo/classic_control/cartpole/config/cartpole_rezero_mz_config.py``, copied
so that the port never loads the zoo file (it imports
``lightzero_tpu.config``).

ReZero is MuZero with a periodic whole-buffer reanalyze that searches
backward in time and reuses each successor's root value
(``buffer_reanalyze_freq``, ``reanalyze_batch_size``,
``reanalyze_partition``, ``reuse_search``). What the zoo file leaves to the
policy comes from ``MuZeroPolicy.default_config()``."""
from lightzero_tpu_torch.config import Config

main_config = Config(dict(
    exp_name="data_rezero/cartpole_rezero_mz_seed0",
    env=dict(type="cartpole", stop_value=195, collector_env_num=8,
             evaluator_env_num=3),
    policy=dict(
        type="muzero",
        model=dict(observation_shape=4, action_space_size=2, model_type="mlp",
                   latent_state_dim=128, support_scale=25,
                   self_supervised_learning_loss=True),
        ssl_loss_weight=2.0,
        num_simulations=25, batch_size=256, update_per_collect=100,
        n_episode=8, eval_freq=100,
        buffer_reanalyze_freq=1.0, reanalyze_batch_size=160,
        reanalyze_partition=0.75, reuse_search=True,
    ),
))
