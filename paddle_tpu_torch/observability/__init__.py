"""Observability of the port: the metrics registry, the flight recorder,
request-scoped tracing, the SLO engine, the HTTP exporter and the
device-trace session, and the fleet collector.

Copies of ``paddle_tpu/observability/{metrics,flight_recorder,
tracing,slo,export}.py`` (pure Python), with the same metric names, and
``device_trace.py`` on ``torch.profiler`` (the JAX package's runs on
``jax.profiler``).  The registry is the port's own, so the two packages
never share a series in one process.  ``collector.py`` is the fleet
collector over the port's RPC transport: a pusher or collector of
either package talks to one of the other.
"""

from paddle_tpu_torch.observability import collector  # noqa: F401
from paddle_tpu_torch.observability.collector import (  # noqa: F401
    CollectorPusher, CollectorServer)

from paddle_tpu_torch.observability import flight_recorder  # noqa: F401
from paddle_tpu_torch.observability import metrics  # noqa: F401
from paddle_tpu_torch.observability import slo  # noqa: F401
from paddle_tpu_torch.observability import tracing  # noqa: F401
from paddle_tpu_torch.observability.slo import SLO, SLOMonitor  # noqa: F401
from paddle_tpu_torch.observability import device_trace  # noqa: F401
from paddle_tpu_torch.observability import export  # noqa: F401
from paddle_tpu_torch.observability.device_trace import \
    DeviceTraceSession  # noqa: F401
from paddle_tpu_torch.observability.export import (  # noqa: F401
    MetricsHTTPServer, metrics_port_from_env, parse_prometheus_text)
from paddle_tpu_torch.observability.flight_recorder import \
    FlightRecorder  # noqa: F401
from paddle_tpu_torch.observability.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, registry)
from paddle_tpu_torch.observability.tracing import (  # noqa: F401
    Span, Tracer, maybe_tracer, start_tracing, stop_tracing)

__all__ = [
    "CollectorPusher", "CollectorServer", "Counter",
    "DeviceTraceSession", "FlightRecorder", "Gauge",
    "Histogram", "MetricsHTTPServer", "MetricsRegistry", "SLO",
    "SLOMonitor", "Span", "Tracer", "collector", "device_trace",
    "flight_recorder", "maybe_tracer", "metrics",
    "metrics_port_from_env", "parse_prometheus_text", "registry",
    "slo", "start_tracing", "stop_tracing", "tracing",
]
