"""GALIP's trainer waiting for the loader (`Trainer.host_seconds
["data_wait"]`, the traced block's own time taken out) over the window's
wall seconds, in percent."""


def read(run):
    if "data_wait_s" not in run.program:
        return None
    return 100.0 * run.program["data_wait_s"] / run.window.seconds
