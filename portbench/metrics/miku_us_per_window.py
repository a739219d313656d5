"""Cluster and MIKU control: the time of the program's
``serving.advance`` and ``serving.idle_advance`` spans that start in the
window over the MIKU windows they fired (each span's ``windows``, the
delta of the ``control.windows`` counter around it), in us."""

from portbench import spans

QUEUE = ("serving.advance", "serving.idle_advance")


def read(run):
    queue = spans.window(run, *QUEUE) or ()
    windows = sum(s.args.get("windows", 0) for s in queue)
    if not windows:
        return None
    return sum(s.t1 - s.t0 for s in queue) / windows * 1e6
