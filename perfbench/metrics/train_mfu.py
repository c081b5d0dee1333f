"""The step's model operations (its family's ``train_flops``, e.g.
``perfbench/families/qwen.py``: every matmul forward and backward, the
head included, attention at the causal half, remat's recomputation left
out) per second of the window, over the card's bf16 peak."""
from perfbench.counts import peaks


def read(obs, device_name):
    if obs.get("kind") != "train":
        return None
    rate = obs["step_flops"] * obs["steps"] / obs["window_s"]
    return 100.0 * rate / peaks(device_name)[0]
