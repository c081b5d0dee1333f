"""The 99th percentile of the latencies of every query sent in the window,
each from when it was due (its scheduled arrival) to its exit stage's
completion, drained queries included (host clock)."""
import numpy as np


def read(obs, device_name):
    lat = obs.get("latencies_s")
    if lat is None or len(lat) == 0:
        return None
    return float(np.percentile(lat, 99) * 1e3)
