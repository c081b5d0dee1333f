"""The share of the traced steps' window in which no device operation ran:
one minus the union of the profiler's kernel and copy intervals over the
window."""


def read(obs, device_name):
    if obs.get("kind") != "train" or not obs.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["trace_window_s"])
