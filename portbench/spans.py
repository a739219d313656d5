"""The program's own real-clock spans, as the ``program_span`` metrics
read them: the span log of ``repro_torch.obs.default_profiler()``, which
the serving engine and cluster record into on the harness's clock
(``time.perf_counter``)."""


def window(run, *names):
    """The spans named ``names`` that start in the run's window, in the
    order they started; None where the program keeps no span log (a tree
    without one) or dropped records from inside the window."""
    try:
        from repro_torch.obs import default_profiler
    except ImportError:
        return None
    found = default_profiler().spans(run.t_open, run.t_close)
    if found is None:
        return None
    return [s for s in found if s.name in names]


def dispatch_ms(run, placement):
    """Mean of the ``serving.decode.dispatch`` spans of the decode steps of
    the engines of ``placement`` that start in the window, in ms; None
    where there are none or nothing can be read."""
    found = window(run, "serving.decode", "serving.decode.dispatch")
    if found is None:
        return None
    decode = {s.sid for s in found
              if s.name == "serving.decode" and s.args.get("placement") == placement}
    steps = [s for s in found if s.name == "serving.decode.dispatch" and s.parent in decode]
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in steps) / len(steps) * 1e3
