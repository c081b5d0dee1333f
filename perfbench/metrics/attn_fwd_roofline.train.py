"""The prefill-attention forward kernel's share of its roofline over the
traced steps: launches x the least time one launch could take (its
operations at the bf16 peak or its bytes at the memory's), over the
kernel's device time in the profiler's trace."""
from perfbench.counts import attention_fwd_kernel, dims, roofline_s

KERNELS = ("flash_attention_bf16_kernel", "flash_attention_fp32_kernel")


def read(obs, device_name):
    kernels, cfg = obs.get("kernels"), obs.get("config")
    if not kernels or cfg is None:
        return None
    rows = [v for k, v in kernels.items() if any(n in k for n in KERNELS)]
    launches, seconds = sum(r[0] for r in rows), sum(r[1] for r in rows)
    if launches == 0 or seconds <= 0:
        return None
    m = dims(cfg)
    flops, nbytes = attention_fwd_kernel(obs["batch"], obs["seq_len"],
                                         m["h"], m["kvh"], m["hd"])
    return 100.0 * launches * roofline_s(flops, nbytes, device_name) / seconds
