from lightzero_tpu_torch.agent.agent import (
    Agent,
    MuZeroAgent,
    EfficientZeroAgent,
    UniZeroAgent,
    StochasticMuZeroAgent,
    GumbelMuZeroAgent,
    AlphaZeroAgent,
    SampledAlphaZeroAgent,
    SampledMuZeroAgent,
    SampledEfficientZeroAgent,
)
from lightzero_tpu_torch.agent.configs import BUNDLED_CONFIGS
