"""The coalescer's fill over the window (`/metrics`): images served over
the rows its dispatches ran (`coalesced_dispatches` x the batch size), in
percent; the rest is padding."""


def read(run):
    p = run.program
    if not p.get("dispatches"):
        return None
    return 100.0 * p["images"] / (p["dispatches"] * p["batch_size"])
