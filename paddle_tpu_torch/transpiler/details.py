"""Transpiler utilities.

Counterpart of ``paddle_tpu/transpiler/details.py`` (reference
python/paddle/fluid/transpiler/details/checkport.py wait_server_ready —
the public helper launch scripts call before starting trainers)."""

from __future__ import annotations

import socket
import time

__all__ = ["wait_server_ready"]


def wait_server_ready(endpoints, timeout=None, poll=0.5):
    """Block until every endpoint accepts TCP connections (reference
    checkport.py:21: connect_ex polling).  timeout=None waits forever,
    matching the reference; otherwise raises TimeoutError listing the
    endpoints that never came up."""
    if isinstance(endpoints, str):
        raise TypeError("endpoints must be a list, not a string")
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        not_ready = []
        for ep in endpoints:
            host, port = ep.rsplit(":", 1)
            # cap the per-socket wait by the remaining deadline so the
            # total never overshoots timeout by 2s per dropped-packet
            # endpoint
            per_sock = 2.0
            if deadline is not None:
                per_sock = max(0.05,
                               min(per_sock,
                                   deadline - time.monotonic()))
            with socket.socket(socket.AF_INET,
                               socket.SOCK_STREAM) as s:
                s.settimeout(per_sock)
                try:
                    ok = s.connect_ex((host or "127.0.0.1",
                                       int(port))) == 0
                except OSError:
                    # name not resolvable yet (e.g. a peer pod's DNS
                    # record appears only once it is up) counts as
                    # not-ready, not an error
                    ok = False
                if not ok:
                    not_ready.append(ep)
        if not not_ready:
            return
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(
                f"servers never became ready: {not_ready}")
        time.sleep(poll)
