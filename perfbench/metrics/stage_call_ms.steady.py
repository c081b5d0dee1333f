"""Mean seconds of one stage call as the workers time it
(``ServeStats.compute_time`` over the window's calls)."""


def read(obs, device_name):
    calls = obs.get("stage_calls")
    if not calls or sum(calls) == 0:
        return None
    return 1e3 * obs["compute_time_s"] / sum(calls)
