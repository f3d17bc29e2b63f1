from lightzero_tpu_torch.search.puct import batch_puct_search
from lightzero_tpu_torch.search.tree import Tree
from lightzero_tpu_torch.search.types import (
    RecurrentOutput,
    RootOutput,
    SearchConfig,
    SearchOutput,
)
