"""Observability: the metrics registry and the request trace recorder.
Pure Python (the port's own copy; it imports nothing of JAX)::

    from repro_torch.obs import TraceRecorder

    eng = CircuitServeEngine(model, cfg, recorder=TraceRecorder())
    ... serve ...
    eng.dump_trace("trace.json")        # open in https://ui.perfetto.dev
    print(eng.metrics_text())           # Prometheus text exposition
"""

from repro_torch.obs.metrics import (DEFAULT_REGISTRY, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     default_registry)
from repro_torch.obs.trace import (NULL_RECORDER, NULL_SPAN, Recorder,
                                   TraceRecorder)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_REGISTRY", "default_registry", "Recorder",
           "TraceRecorder", "NULL_RECORDER", "NULL_SPAN"]
