from repro_torch.models.attention import (KVCache, attn_forward,
                                          cache_write, cross_attn_forward,
                                          decode_attn, encode_cross_kv,
                                          make_kv_cache)
from repro_torch.models.moe import moe_forward, moe_forward_decode, route
from repro_torch.models.ssm import (
    SSM_CHUNK,
    MambaState,
    make_mamba_state,
    mamba_decode,
    mamba_mix,
)
from repro_torch.models.transformer import (
    ModelCache,
    Transformer,
    decode_cache_len,
    from_jax_params,
    param_bytes,
    sinusoidal_pos,
    to_jax_params,
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

__all__ = ["KVCache", "MLSTM_CHUNK", "MLSTMState", "MambaState",
           "ModelCache", "SLSTMState", "SSM_CHUNK", "Transformer",
           "attn_forward", "cache_write", "cross_attn_forward",
           "decode_attn", "decode_cache_len", "encode_cross_kv",
           "from_jax_params", "make_kv_cache", "make_mamba_state",
           "make_mlstm_state", "make_slstm_state", "mamba_decode",
           "mamba_mix", "mlstm_decode", "mlstm_mix", "moe_forward",
           "moe_forward_decode", "param_bytes", "route", "sinusoidal_pos",
           "slstm_decode", "slstm_mix", "to_jax_params"]
