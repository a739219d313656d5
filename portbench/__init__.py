"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on one CUDA card.  Everything that belongs
to one configuration, traffic mix, per-layer metric or cell sits in a file of
its own, found by name:

* ``configs/<config>.json``  the model as it is run;
* ``traffic/<mix>.json``     the engines, clients and length distributions;
* ``metrics/<metric>.py``    one reader per per-layer metric;
* ``limits/<cell>.json``     the limits of the output check.

The yardstick lives here too: the traffic generator (:mod:`portbench.traffic`),
the peaks and the byte and operation counts (:mod:`portbench.counts`), the
reduction of spans and traces (:mod:`portbench.tracing`), and the plain
reference (:mod:`portbench.reference`) with the comparison that decides
``correct`` (:mod:`portbench.check`).  Nothing here imports ``jax`` or the JAX
package; the reference imports nothing of the port.
"""
