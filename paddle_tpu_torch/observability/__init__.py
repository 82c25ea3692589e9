"""Observability of the port: the metrics registry, the flight recorder,
request-scoped tracing and the SLO engine.

Copies of ``paddle_tpu/observability/{metrics,flight_recorder,
tracing,slo}.py`` (pure Python), with the same metric names.  The
registry is the port's own, so the two packages never share a series in
one process.  The HTTP exporter (with ``/sloz`` and the ``/healthz``
degrade), the fleet collector and the device-trace session are not
ported yet (ROADMAP Queue 1 item 4.3).
"""

from paddle_tpu_torch.observability import flight_recorder  # noqa: F401
from paddle_tpu_torch.observability import metrics  # noqa: F401
from paddle_tpu_torch.observability import slo  # noqa: F401
from paddle_tpu_torch.observability import tracing  # noqa: F401
from paddle_tpu_torch.observability.slo import SLO, SLOMonitor  # noqa: F401
