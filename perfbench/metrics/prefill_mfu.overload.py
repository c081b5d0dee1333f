"""The served model work's share of the card's bf16 peak: the operations
of every query completed in the window (each stage's prefill of its
prompt, counted from the config's shapes by its family's
``prefill_flops``), over the window's seconds times the peak."""
from perfbench.counts import peaks


def read(obs, device_name):
    if obs.get("kind") != "serve":
        return None
    work = obs["completed_in_window"] * obs["query_flops"]
    return 100.0 * work / (obs["seconds"] * peaks(device_name)[0])
