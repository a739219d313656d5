"""Model step, as ``decode_dispatch_ms`` reads it, for the host-placed
engines' decode steps (``serving.decode`` with ``placement`` ``host``): the
mean of their ``serving.decode.dispatch`` spans that start in the window, in
ms.  The weight copy is issued before, in ``serving.h2d``; the dispatch is
the graph's replay, which the step's kernels run behind that copy."""

from portbench import spans


def read(run):
    return spans.dispatch_ms(run, "host")
