"""Kernel K4 (``kernels/ssd_scan.py``): the least time of the K4 calls of
the profiled prefills (the configuration's ``k4_calls``: each launch of a
batch-1 prefill, one a SSM layer) over K4's device time in the trace (its
three stages), in %.  Nothing to read for a model without SSM layers, or
when the trace holds another number of calls than the prefills made."""

import math
import sys

from portbench import counts, tracing


def read(run):
    pre = [p for p in run.rec.prefills if p.profiled]
    if not pre or run.trace is None:
        return None
    launches = [run.counts.k4_calls(run.model, p.plen) for p in pre]
    calls = sum(len(ws) for ws in launches)
    if not calls:
        return None
    seen = run.trace.launches(tracing.K4_CALL)
    if seen != calls:
        print(f"k4_roofline_pct: the trace holds {seen} K4 calls, the prefills made {calls}",
              file=sys.stderr)
        return None
    least = sum(math.fsum(w.least_seconds for w in ws) for ws in launches)
    return counts.share_pct(least, run.trace.kernel_seconds(tracing.K4_KERNELS))
