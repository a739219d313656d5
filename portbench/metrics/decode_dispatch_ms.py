"""Model step (``TransformerLM.decode_step`` and the sampler, as the host
launches them; since the decode graph, a replay): the mean of the program's
``serving.decode.dispatch`` spans of the device-placed engines' decode steps
(``serving.decode`` with ``placement`` ``device``) that start in the window,
in ms.  A host engine's steps are read apart (``host_decode_dispatch_ms``):
their dispatch takes 20 to 100 times a device engine's on the card, and they
are a few in a hundred of a tiered cell's steps, so in one mean they would
make it follow how many of them the window holds."""

from portbench import spans


def read(run):
    return spans.dispatch_ms(run, "device")
