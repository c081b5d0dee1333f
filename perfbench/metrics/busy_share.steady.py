"""NVML's GPU utilization (``nvidia-smi``, sampled every 100 ms through
the window), averaged: the share of time in which some kernel ran, with
no measure of how much of the card it used."""


def read(obs, device_name):
    samples = obs.get("utilization")
    if not samples:
        return None
    return sum(samples) / len(samples)
