"""Seconds from the process's start to the window's first arrival or step:
imports, building (first run in a checkout) and loading the kernels,
weights, workers and warm-up (host clock)."""


def read(obs, device_name):
    return obs.get("setup_s")
