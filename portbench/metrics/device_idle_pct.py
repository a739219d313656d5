"""Device (the H100): the share of the traced sub-window in which neither
a kernel nor a copy ran, in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
