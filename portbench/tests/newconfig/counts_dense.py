"""The least-work module of the test configuration ``dense-smoke``: its
layers are all alike, so the yardstick's counts hold; it has no K4."""

from portbench.counts import decode_step, prefill  # noqa: F401


def k4_calls(m, s):
    return []
