"""The trainer's wait for the loader (`Trainer.host_seconds["data_wait"]`)
over the window's wall seconds, in percent."""


def read(run):
    if "data_wait_s" not in run.program:
        return None
    return 100.0 * run.program["data_wait_s"] / run.window.seconds
