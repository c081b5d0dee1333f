"""Mean host milliseconds of the ``step(...)`` call, from the call until it
returns and before its loss is read back: the host's dispatch of a step
(host clock)."""


def read(obs, device_name):
    enq = obs.get("enqueue_s")
    if not enq:
        return None
    return 1e3 * sum(enq) / len(enq)
