from repro_torch.models.attention import KVCache, attn_forward, make_kv_cache
from repro_torch.models.transformer import (
    ModelCache,
    Transformer,
    decode_cache_len,
    from_jax_params,
)

__all__ = ["KVCache", "ModelCache", "Transformer", "attn_forward",
           "decode_cache_len", "from_jax_params", "make_kv_cache"]
