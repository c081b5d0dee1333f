"""The attention backward's share of its roofline over the traced steps:
every kernel that ``repro_torch.kernels.flash_attention.BWD_KERNELS``
names counts toward its device time, and each launch runs
``bwd_delta_kernel`` once, which counts the launches."""
from perfbench.counts import attention_bwd_kernel, dims, roofline_s


def read(obs, device_name):
    from repro_torch.kernels.flash_attention import BWD_KERNELS
    kernels, cfg = obs.get("kernels"), obs.get("config")
    if not kernels or cfg is None:
        return None
    rows = [v for k, v in kernels.items() if any(n in k for n in BWD_KERNELS)]
    launches = sum(v[0] for k, v in kernels.items() if "bwd_delta_kernel" in k)
    seconds = sum(r[1] for r in rows)
    if launches == 0 or seconds <= 0:
        return None
    m = dims(cfg)
    flops, nbytes = attention_bwd_kernel(obs["batch"], obs["seq_len"],
                                         m["h"], m["kvh"], m["hd"])
    return 100.0 * launches * roofline_s(flops, nbytes, device_name) / seconds
