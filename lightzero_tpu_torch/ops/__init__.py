from lightzero_tpu_torch.ops.action import sample_from_visit_counts
from lightzero_tpu_torch.ops.scaling import (
    DiscreteSupport,
    inverse_scalar_transform,
    logits_to_scalar,
)
