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
