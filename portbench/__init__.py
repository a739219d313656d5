"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on one CUDA card.  Everything that belongs
to one configuration, traffic mix, per-layer metric or cell sits in a file of
its own, found by name or by a path that a file names:

* ``configs/<config>.json``  the model as it is run (``model``), with its CPU
  smoke widths (``smoke``), the paths of its plain float32 reference module
  (``reference``: ``logits(m, weights, tokens, positions, *, precision)``
  with ``"f32"`` and ``"fp8"``) and of its least-work module (``counts``:
  ``decode_step(m, active)``, ``prefill(m, s)`` and ``k4_calls(m, s)``), and
  optionally scale rules for its own weight leaves (``weights``: see
  :mod:`portbench.weights`);
* ``reference/<module>.py``  a configuration's reference (``reference/model.py``
  serves the ssm and hybrid blocks of hymba-1.5b and mamba2-2.7b);
* ``counts.py`` or ``work/<module>.py``  a configuration's least work
  (``counts.py`` serves models whose layers are all alike);
* ``traffic/<mix>.json``     the engines, clients and length distributions;
* ``metrics/<metric>.py``    one reader per per-layer metric;
* ``limits/<cell>.json``     the limits of the output check.

So a configuration, a mix, a metric or a cell is added as new files and
entries, with no file here edited.  The yardstick lives here too: the
traffic generator (:mod:`portbench.traffic`), the peaks and the byte and
operation counts (:mod:`portbench.counts`), the reduction of spans and
traces (:mod:`portbench.tracing`), and the plain references with the
comparison that decides ``correct`` (:mod:`portbench.check`).  Nothing here
imports ``jax`` or the JAX package; no reference imports anything of the
port.
"""
