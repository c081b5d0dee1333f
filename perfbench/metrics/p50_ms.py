"""The median latency of the same queries as ``p99_ms`` (host clock)."""
import numpy as np


def read(obs, device_name):
    lat = obs.get("latencies_s")
    if lat is None or len(lat) == 0:
        return None
    return float(np.percentile(lat, 50) * 1e3)
