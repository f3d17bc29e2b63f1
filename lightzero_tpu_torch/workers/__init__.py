from lightzero_tpu_torch.workers.collector import RolloutCollector
from lightzero_tpu_torch.workers.evaluator import Evaluator
from lightzero_tpu_torch.workers.alphazero_workers import (
    AlphaZeroBotEvaluator,
    AlphaZeroSelfPlayCollector,
)
from lightzero_tpu_torch.workers.host_collector import HostCollector, HostEvaluator
