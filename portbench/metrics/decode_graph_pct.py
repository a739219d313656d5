"""Model step (``TransformerLM.decode_step`` and the sampler, as
``ServingEngine.decode_once`` issues them): the share of every engine's
decode steps (``serving.decode``) that start in the window and replayed the
engine's CUDA graph (the span's arg ``graph``), in %.  Nothing to read from
a program whose steps do not say (no ``graph`` arg)."""

from portbench import spans


def read(run):
    steps = [s for s in spans.window(run, "serving.decode") or () if "graph" in s.args]
    if not steps:
        return None
    return 100.0 * sum(1 for s in steps if s.args["graph"]) / len(steps)
