"""Observability of the port: the metrics registry, the flight recorder
and request-scoped tracing.

Copies of ``paddle_tpu/observability/{metrics,flight_recorder,
tracing}.py`` (pure Python), with the same metric names.  The registry
is the port's own, so the two packages never share a series in one
process.  The HTTP exporter, the fleet collector and the device-trace
session are not ported yet.
"""

from paddle_tpu_torch.observability import flight_recorder  # noqa: F401
from paddle_tpu_torch.observability import metrics  # noqa: F401
from paddle_tpu_torch.observability import tracing  # noqa: F401
