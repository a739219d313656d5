"""The batched sweep lane: a whole SimJob grid as one window-lockstep
computation (counterpart of ``repro.memsim.batched``).

* :mod:`.stacking` — per-job exported state stacked into ``(cells,
  workloads, stations)`` float64 arrays on the host;
* :mod:`.fluid` — advances every cell window by window on one device: the
  per-window equilibrium (:func:`.kernel.fused_window_solve`: the Hopper
  kernel on the card, its plain float64 version on the CPU) and the vector
  MIKU ladder, whose decisions throttle the next window;
* :mod:`.tiering` — the vector twin of the tiering hook (host numpy): page
  hotness, migration queues and policies stacked over a group's cells;
* :mod:`.lane` — :func:`run_sweep_batched`, grouping cells by window
  cadence and rung table, and falling the jobs it cannot stack back to
  the scalar DES.
"""

from repro_torch.memsim.batched.lane import (
    can_batch,
    partition_jobs,
    run_sweep_batched,
)

__all__ = ["can_batch", "partition_jobs", "run_sweep_batched"]
