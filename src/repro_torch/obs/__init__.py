"""The port's observability layer: latency histograms
(:mod:`.histogram`), named counters and the phase profiler
(:mod:`.metrics`), and sampled request and transfer tracing with Chrome
trace-event export (:mod:`.trace`)."""

from repro_torch.obs.histogram import LatencyHistogram
from repro_torch.obs.metrics import MetricsRegistry, PhaseProfiler, default_registry
from repro_torch.obs.trace import RequestTracer, TraceConfig, TransferTracer, to_chrome

__all__ = [
    "LatencyHistogram",
    "MetricsRegistry",
    "PhaseProfiler",
    "RequestTracer",
    "TraceConfig",
    "TransferTracer",
    "default_registry",
    "to_chrome",
]
