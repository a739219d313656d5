"""The port's simulated-testbed sweeps (counterpart of ``repro.memsim``)."""
