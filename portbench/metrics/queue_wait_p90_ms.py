"""Engine (``ServingEngine.submit`` to ``admit``): the 90th percentile of
the program's ``serving.queued`` spans, each a request's wait from its
submission to the start of its batch-1 prefill, over the requests
submitted and admitted in the window, in ms."""

from portbench import spans, stats


def read(run):
    waits = [s.t1 - s.t0 for s in spans.window(run, "serving.queued") or ()
             if s.t1 <= run.t_close]
    if not waits:
        return None
    return stats.percentile(waits, 90) * 1e3
