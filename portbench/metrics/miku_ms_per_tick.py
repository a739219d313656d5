"""Cluster and MIKU control (``TransferQueue.advance`` and
``idle_advance``, every MIKU window they fire): the program's
``serving.advance`` and ``serving.idle_advance`` spans that start in the
window, summed, over the window's ``serving.tick`` spans, in ms."""

from portbench import spans

QUEUE = ("serving.advance", "serving.idle_advance")


def read(run):
    found = spans.window(run, "serving.tick", *QUEUE)
    ticks = sum(1 for s in found or () if s.name == "serving.tick")
    queue = [s for s in found or () if s.name in QUEUE]
    if not ticks or not queue:
        return None
    return sum(s.t1 - s.t0 for s in queue) / ticks * 1e3
