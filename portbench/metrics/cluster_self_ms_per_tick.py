"""Cluster and MIKU control (``TieredServingCluster``, ``TransferQueue``,
the controller): the window's wall minus the engines' ``admit`` and
``decode_once`` spans, per tick, in ms."""

from portbench.stats import overlap


def read(run):
    engine = sum(overlap(s.t0, s.t1, run.t_open, run.t_close)
                 for s in run.rec.admits + run.rec.decodes)
    ticks = sum(1 for t in run.rec.tick_starts if run.in_window(t))
    if not ticks:
        return None
    return (run.seconds - engine) / ticks * 1e3
