"""Kernel K1 (``kernels/decode_attention.py``): the least time of the K1
calls of the profiled decode steps (``counts.k1_call``: every slot, each
with its valid rows inside the layer's window) over K1's device time in
the trace (split and combine kernels), in %.  Nothing to read for a model
without attention, or when the trace holds another number of calls than
the steps made."""

import sys

from portbench import counts, tracing


def read(run):
    m = run.model
    layers = counts.attn_layers(m)
    steps = [d for d in run.rec.decodes if d.profiled]
    if not layers or not steps or run.trace is None:
        return None
    calls = len(layers) * len(steps)
    seen = run.trace.launches(tracing.K1_CALL)
    if seen != calls:
        print(f"k1_roofline_pct: the trace holds {seen} K1 calls, the steps made {calls}",
              file=sys.stderr)
        return None
    least = sum(counts.k1_call(counts.k1_keys(m, d.lengths, run.mix.max_len, w), m["n_q_heads"],
                               m["n_kv_heads"], m["head_dim"]).least_seconds
                for d in steps for _, w in layers)
    return counts.share_pct(least, run.trace.kernel_seconds(tracing.K1_KERNELS))
