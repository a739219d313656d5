"""Model step (``TransformerLM.prefill``): the least time of the window's
prefills (the configuration's ``prefill``) over their measured wall, each
from the start of ``admit`` or the previous admission to the first token on
the host, less a host engine's weight copy (``step_params``, the host
tier's), in %."""

from portbench import counts


def read(run):
    pre = [p for p in run.rec.prefills if run.in_window(p.t0)]
    if not pre:
        return None
    least = sum(run.counts.prefill(run.model, p.plen).least_seconds for p in pre)
    return counts.share_pct(least, sum(p.t1 - p.t0 - p.staged for p in pre))
