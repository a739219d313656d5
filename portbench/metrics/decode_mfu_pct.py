"""Model step (``TransformerLM.decode_step`` and its layers): the least
time of the window's decode steps (the configuration's ``decode_step``: the
larger of operations over the bf16 peak and bytes over HBM bandwidth, for
the active slots) over their measured wall, less a host engine's weight copy
(``step_params``, the host tier's), in %."""

from portbench import counts


def read(run):
    steps = [d for d in run.rec.decodes if run.in_window(d.t0)]
    if not steps:
        return None
    least = sum(run.counts.decode_step(run.model, d.active).least_seconds for d in steps)
    return counts.share_pct(least, sum(d.t1 - d.t0 - d.staged for d in steps))
