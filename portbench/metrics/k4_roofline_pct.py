"""Kernel K4 (``kernels/ssd_scan.py``): the least time of the K4 calls of
the profiled prefills (``counts.k4_call``, one a SSM layer a prefill) over
K4's device time in the trace (its three stages), in %.  Nothing to read
when the trace holds another number of calls than the prefills made."""

import sys

from portbench import counts, tracing


def read(run):
    m = run.model
    pre = [p for p in run.rec.prefills if p.profiled]
    if not counts.uses_ssm(m) or not pre or run.trace is None:
        return None
    calls = m["n_layers"] * len(pre)
    seen = run.trace.launches(tracing.K4_CALL)
    if seen != calls:
        print(f"k4_roofline_pct: the trace holds {seen} K4 calls, the prefills made {calls}",
              file=sys.stderr)
        return None
    d = counts.ssm_dims(m)
    least = sum(m["n_layers"] * counts.k4_call(p.plen, d["n_heads"], d["head_dim"],
                                               d["d_state"]).least_seconds for p in pre)
    return counts.share_pct(least, run.trace.kernel_seconds(tracing.K4_KERNELS))
