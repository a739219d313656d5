"""Engine (``ServingEngine.decode_once``): the window's time in decode
steps over their number, in ms.  A host engine's weight copy before each
step (``step_params``) is the host tier's and is left out."""


def read(run):
    steps = [d for d in run.rec.decodes if run.in_window(d.t0)]
    if not steps:
        return None
    return sum(d.t1 - d.t0 - d.staged for d in steps) / len(steps) * 1e3
