"""Queries completed inside the window, over the window's seconds (host
clock); the backlog drained after the window does not count."""


def read(obs, device_name):
    if obs.get("kind") != "serve":
        return None
    return obs["completed_in_window"] / obs["seconds"]
