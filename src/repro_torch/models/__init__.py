from repro_torch.models.attention import KVCache, attn_forward, make_kv_cache
from repro_torch.models.transformer import (
    ModelCache,
    Transformer,
    decode_cache_len,
    from_jax_params,
)
from repro_torch.models.xlstm import (
    MLSTM_CHUNK,
    MLSTMState,
    SLSTMState,
    make_mlstm_state,
    make_slstm_state,
    mlstm_mix,
    slstm_mix,
)

__all__ = ["KVCache", "MLSTM_CHUNK", "MLSTMState", "ModelCache",
           "SLSTMState", "Transformer", "attn_forward", "decode_cache_len",
           "from_jax_params", "make_kv_cache", "make_mlstm_state",
           "make_slstm_state", "mlstm_mix", "slstm_mix"]
