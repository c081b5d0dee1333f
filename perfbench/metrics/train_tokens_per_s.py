"""Every token of the steps run in the window, over the window's seconds
from the first step's call to the last step's loss read back (host
clock)."""


def read(obs, device_name):
    if obs.get("kind") != "train":
        return None
    return obs["tokens"] / obs["window_s"]
