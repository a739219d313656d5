"""Host tier (``HostOffloader``, ``ServingEngine.step_params``): bytes
copied device-ward over the device time of those copies, both the
program's own counters (``bytes_to_device``, ``copy_seconds()``) read as
deltas over the window, in GB/s.  Nothing to read without a host engine."""


def read(run):
    if not run.h2d_bytes or run.h2d_seconds <= 0:
        return None
    return run.h2d_bytes / run.h2d_seconds / 1e9
