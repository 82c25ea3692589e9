"""Alternative HTTP/1.1 RPC transport.

Counterpart of ``paddle_tpu/distributed/http_transport.py``: the same
framing, so an HTTP client of either package talks to an HTTP server of
the other.

Reference parity: the BRPC
transport, operators/distributed/brpc/ — a second wire transport behind
the same RPCClient/RPCServer abstraction, selected at deploy time; the
reference picks it with WITH_BRPC at build time, here
PADDLE_TPU_RPC_TRANSPORT=http at run time).

Same tagged binary wire codec, same handler/barrier semantics — only
the framing differs: each request is one POST /rpc with the
wire-encoded (msg_type, payload) body; the response body is the
wire-encoded ("ok", reply) / ("error", msg) tuple.  Keep-alive
connections give one server thread per client connection, matching the
socket transport's concurrency model (handlers may block in barriers).

Failure semantics ride the shared RPCClient machinery: this class only
provides the framing-specific single exchange (_call_once) and widens
the retryable-exception set with http.client.HTTPException
(IncompleteRead/BadStatusLine/CannotSendRequest — a connection broken
mid-response must be evicted and retried exactly like a broken
socket).  Fault injection (distributed/faultinject.py) hooks the
server's do_POST the same way the socket framing hooks _serve_conn.
"""

from __future__ import annotations

import socket
import threading
import time
from http.client import HTTPConnection, HTTPException
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from paddle_tpu_torch.distributed import faultinject
from paddle_tpu_torch.distributed.rpc import (_RETRYABLE_EXCS, RPCClient,
                                              RPCServer, WireError,
                                              _no_delay, wire_dumps,
                                              wire_loads)

__all__ = ["HTTPRPCServer", "HTTPRPCClient"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"   # keep-alive: thread per connection
    # a reply is written as headers, then body: with Nagle's algorithm
    # on, the body waits for the client's acknowledgement of the headers
    disable_nagle_algorithm = True

    def log_message(self, *args):   # quiet
        pass

    def _abort(self):
        """Sever the connection without a response: the client sees a
        RemoteDisconnected/IncompleteRead, evicts, and (when the msg
        type allows) retries."""
        self.close_connection = True
        try:
            self.connection.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def do_POST(self):
        rpc = self.server._rpc
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
        except (ValueError, OSError):
            self.send_error(400)
            return
        try:
            msg = wire_loads(body)
        except WireError as e:
            reply = ("error", f"bad wire frame: {e}")
        else:
            fault = None
            inj = faultinject.maybe_injector()
            if inj is not None and isinstance(msg, tuple) \
                    and len(msg) == 2 and isinstance(msg[0], str):
                fault = inj.decide(msg[0])
            if fault is not None:
                steps = faultinject.steps_of(fault)
                if steps[0][0] in ("close", "kill"):
                    # request-loss: the handler never runs
                    self._abort()
                    return
                reply = rpc._dispatch(msg)  # shared with socket framing
                # chains apply in order: delays first (after the
                # handler), then at most one terminal step
                for kind, arg in steps:
                    if kind == "delay":
                        time.sleep(arg)
                    elif kind == "drop":
                        self._abort()       # executed, reply discarded
                        return
                    elif kind == "truncate":
                        out = wire_dumps(reply)
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/octet-stream")
                        self.send_header("Content-Length",
                                         str(len(out)))
                        self.end_headers()
                        self.wfile.write(
                            out[:max(1, int(len(out) * arg))])
                        self.wfile.flush()
                        self._abort()       # mid-body close
                        return
            else:
                reply = rpc._dispatch(msg)  # shared with socket framing
        try:
            out = wire_dumps(reply)
        except WireError as e:
            out = wire_dumps(("error",
                              f"reply not wire-encodable: {e}"))
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)


class HTTPRPCServer(RPCServer):
    """Drop-in RPCServer over HTTP framing."""

    def __init__(self, endpoint: str):
        host, port = endpoint.rsplit(":", 1)
        host = host or "127.0.0.1"
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd._rpc = self
        self._httpd.daemon_threads = True
        self.endpoint = f"{host}:{self._httpd.server_address[1]}"
        self._init_rpc_state()   # handlers/barriers/dedup + health RPC

    def start(self):
        self._serving = True
        t = threading.Thread(target=self._httpd.serve_forever,
                             kwargs={"poll_interval": 0.2}, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        # shutdown() blocks on an event only serve_forever() sets —
        # calling it on a never-started server would deadlock
        if getattr(self, "_serving", False):
            self._httpd.shutdown()
        self._httpd.server_close()


class HTTPRPCClient(RPCClient):
    """Drop-in RPCClient over HTTP framing: per-endpoint keep-alive
    connection + lock, connect-retry, and the shared deadline/retry/
    dedup/circuit-breaker loop from RPCClient.call."""

    _RETRYABLE = _RETRYABLE_EXCS + (HTTPException,)

    def _connect(self, endpoint, timeout=None):
        timeout = self._TIMEOUT if timeout is None else timeout
        host, port = endpoint.rsplit(":", 1)
        conn = HTTPConnection(host or "127.0.0.1", int(port),
                              timeout=timeout)
        deadline = time.monotonic() + timeout
        while True:
            try:
                conn.connect()
                # a request goes out as headers, then body (the reply's
                # note on _Handler)
                _no_delay(conn.sock)
                return conn
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)

    # _get_conn inherited from RPCClient: per-endpoint connect lock
    # (one dead endpoint's retry never stalls the others); only
    # _connect differs by framing

    def _set_attempt_timeout(self, conn, timeout):
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)

    def _call_once(self, endpoint, msg_type, payload, timeout):
        conn, lock = self._get_conn(endpoint, timeout=timeout)
        try:
            with lock:
                self._set_attempt_timeout(conn, timeout)
                body = wire_dumps((msg_type, payload))
                conn.request("POST", "/rpc", body=body, headers={
                    "Content-Type": "application/octet-stream"})
                resp = conn.getresponse()
                data = resp.read()
            status, reply = wire_loads(data)
        except self._RETRYABLE:
            # HTTPException covers IncompleteRead/BadStatusLine/
            # CannotSendRequest — a connection broken mid-response must
            # be evicted like the socket client does, or the endpoint
            # stays wedged after a pserver restart (the per-endpoint
            # lock object persists, matching RPCClient._evict)
            self._evict(endpoint, conn)
            raise
        self._breaker_ok(endpoint)
        if status == "error":
            raise RuntimeError(
                f"RPC '{msg_type}' to {endpoint} failed: {reply}")
        return reply

    # close() inherited: RPCClient.close() already iterates and closes
    # the cached connections (HTTPConnection.close matches the shape)
