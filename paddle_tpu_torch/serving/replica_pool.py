"""The failure types of a serving replica.

Counterpart of ``paddle_tpu/serving/replica_pool.py:66-71``.  The
replica pool itself (health probes, circuit breakers, mesh slices) is
not ported yet; the decode engine raises and catches these two.
"""

from __future__ import annotations

__all__ = ["ReplicaKilled", "ReplyLost"]


class ReplicaKilled(RuntimeError):
    """The replica process/thread died (injected ``kill``)."""


class ReplyLost(RuntimeError):
    """Transient execution failure; the batch is safe to requeue."""
