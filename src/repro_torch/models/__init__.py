from repro_torch.models.attention import (KVCache, attn_forward,
                                          cache_write, decode_attn,
                                          make_kv_cache)
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
    mlstm_decode,
    mlstm_mix,
    slstm_decode,
    slstm_mix,
)

__all__ = ["KVCache", "MLSTM_CHUNK", "MLSTMState", "ModelCache",
           "SLSTMState", "Transformer", "attn_forward", "cache_write",
           "decode_attn", "decode_cache_len", "from_jax_params",
           "make_kv_cache", "make_mlstm_state", "make_slstm_state",
           "mlstm_decode", "mlstm_mix", "slstm_decode", "slstm_mix"]
