"""Share of the stage calls' rows that carried a query: every completed
query passes each stage once, over the calls the stages made in the
window (counted by the recording stage, checked against the workers'
exit reports) times the batch size."""


def read(obs, device_name):
    calls = obs.get("stage_calls")
    if not calls or sum(calls) == 0:
        return None
    return 100.0 * obs["completed"] * len(calls) / (sum(calls) * obs["batch"])
