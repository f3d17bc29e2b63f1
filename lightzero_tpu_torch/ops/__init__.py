from lightzero_tpu_torch.ops.action import sample_from_visit_counts
from lightzero_tpu_torch.ops.scaling import (
    DiscreteSupport,
    cross_entropy_loss,
    inverse_scalar_transform,
    logits_to_scalar,
    phi_transform,
    scalar_transform,
    visit_count_temperature,
)
