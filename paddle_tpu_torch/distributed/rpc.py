"""The health-probe interval knob of the RPC layer.

Counterpart of ``paddle_tpu/distributed/rpc.py:81-100``: only
``health_probe_interval`` and the env reader it needs.  The socket
transport, its servers, clients and barriers are not ported yet
(ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import os

__all__ = ["health_probe_interval"]


def _env_float(name, default):
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return float(v)


def health_probe_interval(default=1.0):
    """Seconds between liveness probes, read from
    ``PADDLE_TPU_HEALTH_INTERVAL`` (the serving replica pool and any
    other prober consume this one knob; see docs/SERVING.md)."""
    return _env_float("PADDLE_TPU_HEALTH_INTERVAL", default)
