"""Model step (``TransformerLM.decode_step`` and the sampler, as the host
launches them): the mean of the program's ``serving.decode.dispatch`` spans
of the device-placed engines' decode steps (``serving.decode`` with
``placement`` ``device``) that start in the window, in ms.  A host engine's
steps are left out: its weight copy runs on a side stream that the step's
kernels wait for on the device, and its dispatch time holds part of that
copy (the host's launches stall behind the waiting kernels).  The copy
belongs to the host tier, which ``copy_seconds()`` measures."""

from portbench import spans


def read(run):
    found = spans.window(run, "serving.decode", "serving.decode.dispatch")
    if found is None:
        return None
    device = {s.sid for s in found
              if s.name == "serving.decode" and s.args.get("placement") == "device"}
    steps = [s for s in found if s.name == "serving.decode.dispatch" and s.parent in device]
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in steps) / len(steps) * 1e3
