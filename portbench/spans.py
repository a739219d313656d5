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
