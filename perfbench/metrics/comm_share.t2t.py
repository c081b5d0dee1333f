"""``ServeStats.summary()["comm_frac"]``: the hand-off's share of the
workers' compute plus hand-off seconds over the window's calls."""


def read(obs, device_name):
    if obs.get("kind") != "serve":
        return None
    return 100.0 * obs["comm_frac"]
