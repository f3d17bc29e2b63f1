from lightzero_tpu_torch.entry.train_alphazero import eval_alphazero, train_alphazero
from lightzero_tpu_torch.entry.train_muzero import eval_muzero, train_muzero

# ReZero is the shared loop with buffer_reanalyze_freq > 0, and the segment
# pipeline the shared loop with policy.num_segments set, as in the JAX
# package's entry/__init__.py
train_rezero = train_muzero
train_muzero_segment = train_muzero
# UniZero and Sampled UniZero share the loop too, chosen by policy.type
train_unizero = train_muzero
eval_unizero = eval_muzero
train_unizero_segment = train_muzero

from lightzero_tpu_torch.entry.train_muzero_multitask import train_muzero_multitask
from lightzero_tpu_torch.entry.train_multitask_balance import train_multitask_balance

# the reference's multitask entry names, as the JAX package maps them: the
# ddp-segment entries to the multitask entry, the balance variant to the
# curriculum entry
train_muzero_multitask_segment_ddp = train_muzero_multitask
train_unizero_multitask_segment_ddp = train_muzero_multitask
train_unizero_multitask_balance_segment_ddp = train_multitask_balance

from lightzero_tpu_torch.entry.train_muzero_with_reward_model import train_muzero_with_reward_model
from lightzero_tpu_torch.entry.eval_offline import eval_offline

# gym envs go through the host path of the shared loop, as in the JAX
# package (the reference keeps dedicated train/eval_muzero_with_gym_env
# entries); eval_muzero refuses a host env where the JAX one fails
train_muzero_with_gym_env = train_muzero
eval_muzero_with_gym_env = eval_muzero
# the reference's multitask _eval entry: the offline sweep of a run's
# checkpoints
train_unizero_multitask_segment_eval = eval_offline


def train_unizero_with_loss_landscape(cfg, *args, **kwargs):
    """The shared loop with its post-training loss-landscape analysis
    (reference lzero/entry/train_unizero_with_loss_landscape.py), as the
    JAX package's entry/__init__.py defines it: sets
    ``policy.analysis_loss_landscape`` on ``cfg`` (the main config of a
    [main, create] pair) and calls ``train_muzero``."""
    if isinstance(cfg, (list, tuple)):
        cfg = cfg[0]
    cfg["policy"]["analysis_loss_landscape"] = True
    return train_muzero(cfg, *args, **kwargs)
