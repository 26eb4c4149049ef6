"""The server's own milliseconds a successful /generate over the window
(`/metrics`: `generate_seconds_total` over `generate_ok`): the wait for
the dispatch lock, the pipeline and the PNG encode, on the server's
clock."""


def read(run):
    p = run.program
    if not p.get("generate_ok"):
        return None
    return 1e3 * p["generate_s"] / p["generate_ok"]
