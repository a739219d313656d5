"""Host tier: the device time of the device-ward weight copies
(``copy_seconds()``, a delta over the window) over the window's wall, in %.
Nothing to read without a host engine."""


def read(run):
    if not run.h2d_bytes:
        return None
    return 100.0 * run.h2d_seconds / (run.t_return - run.t_open)
