"""Open-loop workload generation (arrival processes + trace replay; a copy of
``repro.workload``).

The DES's native workloads are closed loops: each core re-issues as soon
as a request retires, so the offered load self-throttles to whatever the
memory system sustains.  The serving regime, and the
regime where the paper's unfair-queuing/DDR-collapse mechanisms bite
hardest — is *open-loop*: requests arrive at an offered rate the system
cannot refuse, and queues grow when it falls behind.

:class:`~repro_torch.workload.arrivals.ArrivalSpec` describes one arrival
process (Poisson, Zipfian-keyed, bursty/periodic, diurnal, flash-crowd, or
trace-file replay); attached to a :class:`~repro_torch.core.des.WorkloadSpec`
via ``arrival=`` it turns that workload open-loop.  Generators are
deterministic given their seeds, draw from dedicated RNG streams (never
the simulation's), and use no wall-clock.
"""

from repro_torch.workload.arrivals import (
    ArrivalSpec,
    arrival_iter,
    arrival_times,
)

__all__ = ["ArrivalSpec", "arrival_iter", "arrival_times"]
