"""MoE experts (``models/moe.py``'s dropless layer): the least time of the
routed expert products of the profiled decode steps and prefills over the
device time of the grouped expert-product kernels in the trace, found by
name among its busiest device operations, in %.

The least time counts each held expert touched as its two matrices read
once (2 x d_model x d_ff bf16 weights) and each request routed to a held
expert as 4 x d_model x d_ff operations (the configuration's
``expert_work``).  The two counts are the program's own, the ``moe_requests``
and ``moe_experts`` args of the profiled steps' ``serving.decode`` and
``serving.prefill`` spans, where every profiled step has one; else their
expectation under uniform routing (the configuration's ``moe_expected``).
Nothing to read, with the reason printed, for a configuration without
routed-expert counts or a trace without the grouped kernels."""

import sys

from portbench import counts

#: The grouped products' kernel, ``torch._grouped_mm``'s CUTLASS
#: ``GemmUniversal`` over a ``GroupProblemShape``: the trace names it
#: mangled, and the breakdown keeps its first ``tracing.NAME_CHARS``
#: characters, which end before the problem shape.  It is the one kernel
#: of PyTorch's own CUTLASS 3.x builds that the port launches (its other
#: products are cuBLAS's).
GROUPED = "enable_3x_kernel_for_sm9x"


def _program_counts(run, steps):
    """(requests, experts) summed over the profiled steps' spans, or None
    where the program records no such args for every step."""
    try:
        from repro_torch.obs import default_profiler
    except ImportError:
        return None
    t0, t1 = min(s.t0 for s in steps), max(s.t1 for s in steps)
    found = default_profiler().spans(t0, t1)
    if found is None:
        return None
    moe = [s for s in found if s.name in ("serving.decode", "serving.prefill")
           and "moe_experts" in s.args]
    if len(moe) != len(steps):
        return None
    return (sum(s.args["moe_requests"] for s in moe), sum(s.args["moe_experts"] for s in moe))


def read(run):
    if not hasattr(run.counts, "expert_work") or run.trace is None:
        return None
    steps = ([d for d in run.rec.decodes if d.profiled]
             + [p for p in run.rec.prefills if p.profiled])
    if not steps:
        return None
    kernel_s = sum(s for name, s in run.trace.device_ops if GROUPED in name)
    if kernel_s <= 0:
        print("moe_roofline_pct: no grouped expert kernel among the trace's busiest operations",
              file=sys.stderr)
        return None
    got = _program_counts(run, steps)
    if got is None:
        tokens = [len(d.active) for d in run.rec.decodes if d.profiled]
        tokens += [p.plen for p in run.rec.prefills if p.profiled]
        expected = [run.counts.moe_expected(run.model, n) for n in tokens]
        got = (sum(r for r, _ in expected), sum(e for _, e in expected))
    least = run.counts.expert_work(run.model, *got).least_seconds
    return counts.share_pct(least, kernel_s)
