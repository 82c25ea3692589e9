"""Observability of the port: the metrics registry, the flight recorder,
request-scoped tracing, the SLO engine, the HTTP exporter and the
device-trace session.

Copies of ``paddle_tpu/observability/{metrics,flight_recorder,
tracing,slo,export}.py`` (pure Python), with the same metric names, and
``device_trace.py`` on ``torch.profiler`` (the JAX package's runs on
``jax.profiler``).  The registry is the port's own, so the two packages
never share a series in one process.  The fleet collector is not ported
yet (ROADMAP Queue 1 item 4.3).
"""

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
