from lightzero_tpu_torch.models.unizero_world_model.transformer import (
    KVCache,
    Transformer,
    TransformerConfig,
    init_kv_cache,
)
