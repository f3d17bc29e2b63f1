from lightzero_tpu_torch.models.common import NetworkOutput
from lightzero_tpu_torch.models.muzero import MuZeroModel
