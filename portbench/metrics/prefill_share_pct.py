"""Engine (``ServingEngine.admit``, each request's batch-1 prefill): the
share of the window spent in ``admit``, less a host engine's weight copies
inside it (``step_params``, the host tier's), in %."""

from portbench.stats import overlap


def read(run):
    t = sum(overlap(s.t0, s.t1, run.t_open, run.t_close)
            for s in run.rec.admits) - sum(overlap(s.t0, s.t1, run.t_open, run.t_close)
                                           for s in run.rec.stagings["prefill"])
    return 100.0 * t / run.seconds
