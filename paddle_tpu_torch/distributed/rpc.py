"""Socket RPC for the parameter-server control plane.

Counterpart of ``paddle_tpu/distributed/rpc.py``, the same wire byte for
byte: a message is a length-prefixed frame in a small self-describing
tagged binary codec (ndarrays as dtype/shape/raw-bytes headers), which
can only describe data, never code.  A client or server of either
package talks to one of the other.

Reference parity: ``RPCClient`` (AsyncSendVar/AsyncGetVar/barriers,
rpc_client.h:33), ``RPCServer`` with its handler registry and barriers
(rpc_server.h:48, request_handler.h:148), the wire's VariableMessage
(send_recv.proto.in:47).

Tensors crossing this layer are host numpy arrays: a torch tensor is
encoded as the numpy array of its host copy (a card tensor is copied
through page-locked memory, ``core/types.to_numpy``), so its bytes are
the JAX package's.  The receiver always gets numpy; the op that consumes
it places it on its executor's device.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import threading
import uuid
from collections import OrderedDict

import numpy as np
import torch

from paddle_tpu_torch.core.types import to_numpy
from paddle_tpu_torch.distributed import faultinject
from paddle_tpu_torch.observability import flight_recorder as _flight
from paddle_tpu_torch.observability import metrics as _obs_metrics
from paddle_tpu_torch.observability import tracing as _trace

_LEN = struct.Struct("!Q")
_I64 = struct.Struct("!q")
_F64 = struct.Struct("!d")
_U32 = struct.Struct("!I")


class WireError(ValueError):
    """Malformed or forbidden wire content (never code execution — the
    codec has no notion of callables or class reconstruction)."""


class RPCDeadlineExceeded(TimeoutError):
    """A call (including its transparent retries) ran out of its
    deadline budget.  TimeoutError subclass, so it is also an OSError —
    existing broad handlers keep working."""


class CircuitOpenError(ConnectionError):
    """Fail-fast: the per-endpoint circuit breaker is open after
    consecutive transport failures; retried after the cooldown."""


class BarrierTimeoutError(RuntimeError):
    """A server-side barrier missed its deadline.  The message is the
    one-line diagnostic contract tools/check_test_hung.py parses:

      barrier 'NAME' @ ENDPOINT timed out after T s: K/N arrivals,
      waiters=[...]
    """

    def __init__(self, name, endpoint, timeout, arrived, needed):
        self.barrier_name = name
        self.endpoint = endpoint
        self.arrived = list(arrived)
        self.needed = int(needed)
        waiters = [p for p in self.arrived if isinstance(p, str)]
        super().__init__(
            f"barrier '{name}' @ {endpoint} timed out after "
            f"{float(timeout):g}s: {len(self.arrived)}/{self.needed} "
            f"arrivals, waiters={waiters!r}")


def _env_float(name, default):
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return float(v)


def _env_int(name, default):
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return int(v)


def health_probe_interval(default=1.0):
    """Seconds between liveness probes against a server's built-in
    'health' handler, read from ``PADDLE_TPU_HEALTH_INTERVAL`` (the
    serving replica pool and any other prober consume this one knob;
    see docs/SERVING.md / docs/FAULT_TOLERANCE.md)."""
    return _env_float("PADDLE_TPU_HEALTH_INTERVAL", default)


# transport-level failures worth a transparent retry; handler ("error",
# ...) replies are application errors and are NEVER retried
_RETRYABLE_EXCS = (ConnectionError, TimeoutError, OSError, WireError)

_DEDUP_CACHE_SIZE = 4096
_DEDUP_TAG = "__seq1__"
# trace-context envelope: ("__trace1__", trace_id, span_id, inner) —
# wrapped OUTSIDE the dedup envelope by RPCClient.call when tracing is
# on, unwrapped first by RPCServer._dispatch so the server-side handler
# span joins the caller's trace (docs/OBSERVABILITY.md)
_TRACE_TAG = "__trace1__"
# msg types exempt from the trace envelope AND the server-side handler
# span: the fleet collector's own push RPC must never open
# trace roots — a traced push would be exported by the NEXT push, and
# the observability plane would observe itself without bound.  The
# exemption also keeps push payload bytes independent of whether the
# pushing process happens to trace.
_UNTRACED_MSG_TYPES = frozenset({"collector_push"})

# -- observability instruments: the registry is the ONE
# source of truth; RPCClient.stats() is a view over these (the
# breaker/registry split fix — tests assert the two never drift)
_M_CLIENT = {
    "calls": _obs_metrics.counter(
        "paddle_tpu_rpc_client_calls_total",
        "RPC calls started, by client/endpoint", max_series=4096),
    "retries": _obs_metrics.counter(
        "paddle_tpu_rpc_client_retries_total",
        "transparent transport retries", max_series=4096),
    "deadline_misses": _obs_metrics.counter(
        "paddle_tpu_rpc_client_deadline_misses_total",
        "calls that blew their deadline budget", max_series=4096),
    "failures": _obs_metrics.counter(
        "paddle_tpu_rpc_client_failures_total",
        "TERMINAL call failures (retries exhausted / deadline blown "
        "/ breaker trip)", max_series=4096),
}
_M_BREAKER_OPENS = _obs_metrics.counter(
    "paddle_tpu_rpc_breaker_opens_total",
    "circuit-breaker open transitions, by endpoint", max_series=1024)
_M_SRV_REQS = _obs_metrics.counter(
    "paddle_tpu_rpc_server_requests_total",
    "server-side dispatches, by msg_type/status", max_series=256)
_M_SRV_SECONDS = _obs_metrics.histogram(
    "paddle_tpu_rpc_server_handler_seconds",
    "server-side handler latency, by msg_type", max_series=128)


_MAX_DEPTH = 32


def _enc_len_bytes(b: bytes) -> bytes:
    try:
        return _U32.pack(len(b)) + b
    except struct.error:
        raise WireError("str/bytes payload over u32 length limit") from None


def _encode(obj, out, depth=0):
    """Tagged binary encoding.  Supported: None, bool, int, float, str,
    bytes, np.ndarray/np scalar, torch.Tensor (as the numpy array of its
    host copy), list, tuple, dict (str-ish keys ok).
    Depth-capped like the decoder, so cyclic/over-deep payloads fail at
    the sender with WireError, not RecursionError at the peer."""
    if depth > _MAX_DEPTH:
        raise WireError("nesting too deep (or cyclic payload)")
    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, torch.Tensor):
        _encode(to_numpy(obj, "wire payload"), out, depth)
    elif isinstance(obj, (np.ndarray, np.generic)):
        # before int/float: np.float64 is a builtin-float subclass and
        # would otherwise degrade to 'f' while float32 stays an array
        arr = np.asarray(obj)
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")  # (ascontiguousarray would 1-d-ify 0-d)
        if arr.dtype.hasobject or arr.dtype.names is not None \
                or arr.dtype.kind not in "biufcSU":
            raise WireError(
                f"arrays of dtype kind {arr.dtype.kind!r} are not "
                "wire-encodable (plain numeric/bool/bytes/str only)")
        out.append(b"a" + _enc_len_bytes(arr.dtype.str.encode("ascii"))
                   + _U32.pack(arr.ndim)
                   + b"".join(_I64.pack(d) for d in arr.shape)
                   + _LEN.pack(arr.nbytes))
        # the array's own buffer, not a copy: the frame is written
        # part by part (_send_msg) or joined once (wire_dumps)
        out.append(memoryview(arr.reshape(-1).view(np.uint8)))
    elif isinstance(obj, int):
        try:
            out.append(b"i" + _I64.pack(obj))
        except struct.error:
            raise WireError("int out of int64 range") from None
    elif isinstance(obj, float):
        out.append(b"f" + _F64.pack(obj))
    elif isinstance(obj, str):
        out.append(b"s" + _enc_len_bytes(obj.encode("utf-8")))
    elif isinstance(obj, bytes):
        out.append(b"b" + _enc_len_bytes(obj))
    elif isinstance(obj, (list, tuple)):
        try:
            hdr = _U32.pack(len(obj))
        except struct.error:
            raise WireError("container over u32 length limit") from None
        out.append((b"l" if isinstance(obj, list) else b"t") + hdr)
        for item in obj:
            _encode(item, out, depth + 1)
    elif isinstance(obj, dict):
        try:
            hdr = _U32.pack(len(obj))
        except struct.error:
            raise WireError("container over u32 length limit") from None
        out.append(b"d" + hdr)
        for k, v in obj.items():
            _encode(k, out, depth + 1)
            _encode(v, out, depth + 1)
    else:
        raise WireError(
            f"type {type(obj).__name__} is not wire-encodable")


class _Reader:
    """Reads a frame through a memoryview: every field is a view of the
    frame, an ndarray's payload too where the frame is writable."""

    def __init__(self, data: bytes):
        self.data = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise WireError("truncated message")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self):
        return _U32.unpack(self.take(4))[0]

    def decode(self, depth=0):
        if depth > _MAX_DEPTH:
            raise WireError("nesting too deep")
        tag = bytes(self.take(1))
        if tag == b"N":
            return None
        if tag == b"T":
            return True
        if tag == b"F":
            return False
        if tag == b"i":
            return _I64.unpack(self.take(8))[0]
        if tag == b"f":
            return _F64.unpack(self.take(8))[0]
        if tag == b"s":
            return bytes(self.take(self.u32())).decode("utf-8")
        if tag == b"b":
            return bytes(self.take(self.u32()))
        if tag == b"a":
            try:
                dtype = np.dtype(bytes(self.take(self.u32())).decode(
                    "ascii"))
            except TypeError as e:
                raise WireError(f"bad ndarray dtype: {e}") from None
            # decode must be the exact inverse of encode: reject dtype
            # kinds the encoder refuses (object/structured/void, and
            # anything outside plain numeric/bool/bytes/str kinds)
            if dtype.hasobject or dtype.names is not None or \
                    dtype.kind not in "biufcSU":
                raise WireError(
                    f"dtype kind {dtype.kind!r} is not wire-decodable")
            ndim = self.u32()
            if ndim > 32:
                raise WireError("ndarray rank too large")
            shape = tuple(_I64.unpack(self.take(8))[0]
                          for _ in range(ndim))
            nbytes = _LEN.unpack(self.take(8))[0]
            expect = int(np.prod(shape)) * dtype.itemsize if shape else \
                dtype.itemsize
            if any(d < 0 for d in shape) or nbytes != expect:
                raise WireError("ndarray header/payload mismatch")
            arr = np.frombuffer(self.take(nbytes),
                                dtype=dtype).reshape(shape)
            # a frame read off the socket is a fresh writable buffer of
            # this message alone: its arrays are views of it; a frame
            # given as bytes is copied out, as the JAX package does
            return arr if arr.flags.writeable else arr.copy()
        if tag in (b"l", b"t"):
            n = self.u32()
            items = [self.decode(depth + 1) for _ in range(n)]
            return items if tag == b"l" else tuple(items)
        if tag == b"d":
            n = self.u32()
            return {self.decode(depth + 1): self.decode(depth + 1)
                    for _ in range(n)}
        raise WireError(f"unknown wire tag {tag!r}")


def wire_dumps(obj) -> bytes:
    out = []
    _encode(obj, out)
    return b"".join(out)


def wire_loads(data: bytes):
    r = _Reader(data)
    try:
        obj = r.decode()
    except WireError:
        raise
    except (TypeError, ValueError, UnicodeDecodeError,
            struct.error) as e:  # malformed headers -> WireError, not leaks
        raise WireError(f"malformed wire message: {e}") from None
    if r.pos != len(data):
        raise WireError("trailing bytes after message")
    return obj


def _send_msg(sock, obj):
    """One length-prefixed frame, the bytes of ``wire_dumps`` after the
    length, written part by part: an array's payload goes out from its
    own buffer, never joined into a copy of the frame."""
    out = []
    _encode(obj, out)
    n = sum(len(b) for b in out)
    head, parts = [_LEN.pack(n)], []
    for b in out:
        # small header parts coalesce into one write
        if len(b) < 65536:
            head.append(b)
        else:
            parts.append(b"".join(head))
            parts.append(b)
            head = []
    parts.append(b"".join(head))
    for b in parts:
        if len(b):
            sock.sendall(b)


def _no_delay(sock):
    """A frame goes out in several writes (``_send_msg``): with Nagle's
    algorithm on, its small last write would wait for the peer's
    acknowledgement of the ones before."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


def _recv_exact(sock, n):
    """``n`` bytes read into one preallocated, writable buffer (a frame
    of an array of hundreds of MB arrives in many chunks; its arrays
    are decoded as views of it)."""
    buf = np.empty(n, np.uint8)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _recv_msg(sock):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return wire_loads(_recv_exact(sock, n))


class RPCServer:
    """Threaded request server: one handler per message type.

    handler(payload) -> reply (anything wire-encodable — scalars, str,
    bytes, numpy arrays, lists/tuples/dicts; None is fine).  Handlers
    run on connection threads; use locks for shared state (the reference
    serializes through its RequestHandler Get/Set with barriers —
    rpc_server.h:48 registered barriers map to `barrier` here).
    """

    def __init__(self, endpoint: str):
        host, port = endpoint.rsplit(":", 1)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host or "127.0.0.1", int(port)))
        self._sock.listen(128)
        self.endpoint = f"{host or '127.0.0.1'}:{self._sock.getsockname()[1]}"
        self._init_rpc_state()

    def _init_rpc_state(self):
        """Framing-independent server state (socket + HTTP subclasses)."""
        self._handlers = {}
        self._stop = threading.Event()
        self._threads = []
        self._dyn_barriers: dict = {}
        self._barrier_lock = threading.Lock()
        # exactly-once dedup: (client_id, seq) -> cached ok-reply for
        # msg types the client marks non-idempotent (send_var & co);
        # a retry whose original DID execute returns the cached reply
        # instead of re-running the handler
        self._dedup: OrderedDict = OrderedDict()
        self._dedup_lock = threading.Lock()
        self.register_handler("health", self._health)

    def _health(self, _payload=None):
        """Built-in liveness/readiness RPC (reference: BRPC health
        checks); clients probe it with a short deadline and no retry."""
        return {"status": "ok", "endpoint": self.endpoint,
                "pid": os.getpid(),
                "msg_types": sorted(self._handlers)}

    def register_handler(self, msg_type: str, fn):
        faultinject.register_msg_type(msg_type)
        self._handlers[msg_type] = fn

    # -- barrier support (reference rpc_server.h RegisterBarrier) -----------
    def barrier(self, name: str, count: int, timeout=None) -> int:
        """Blocks the calling handler until `count` parties arrived;
        returns 0 for exactly one of them (the leader, elected at
        release) so one caller can do post-barrier work, and 1 for the
        rest.  Fixed-count convenience over barrier_dynamic (one
        implementation, one release semantics)."""
        return self.barrier_dynamic(name, lambda: count, timeout=timeout)

    def reset_barrier(self, name: str):
        with self._barrier_lock:
            self._dyn_barriers.pop(name, None)

    def barrier_dynamic(self, name: str, count_fn, poll=0.25,
                        peer=None, alive_fn=None, timeout=None) -> int:
        """Like barrier(), but the required party count is re-evaluated
        every `poll` seconds — the survivor-continue primitive: when a
        trainer dies mid-step, count_fn (e.g. fanin - dead_trainers)
        drops and the remaining waiters release instead of deadlocking
        (reference rpc_server.h:48 barriers are fixed-count; the
        reference cluster simply hangs on a dead trainer).

        peer/alive_fn: arrival identity + liveness predicate.  Only
        LIVE arrivals satisfy the count — an arrival from a peer that
        gets fenced while waiting must not release the barrier in place
        of a live straggler.  A DUPLICATE arrival from a peer already
        waiting in this generation (a transparently retried barrier RPC
        whose reply was lost) does not add a second count — barriers
        retry freely without phantom releases.  Returns 0 for exactly
        one LIVE waiter per generation (the leader, elected at release
        time — arrival order can't elect, the first arriver might be
        fenced by then) and a positive index for the rest.

        timeout: seconds before a waiter gives up with a
        BarrierTimeoutError naming the barrier, the endpoint, and the
        waiters seen (instead of hanging the job forever).  None reads
        PADDLE_TPU_BARRIER_TIMEOUT (default 600s); <= 0 disables."""
        import time

        if timeout is None:
            timeout = _env_float("PADDLE_TPU_BARRIER_TIMEOUT", 600.0)
        deadline = (time.monotonic() + float(timeout)) \
            if timeout and timeout > 0 else None
        with self._barrier_lock:
            b = self._dyn_barriers.get(name)
            if b is None:
                b = self._dyn_barriers[name] = {
                    "cond": threading.Condition(),
                    "arrived": [], "gen": 0, "leader_taken": False}
        c = b["cond"]
        token = object() if peer is None else str(peer)
        _flight.record("barrier", "arrive", name=name,
                       endpoint=self.endpoint,
                       peer=None if peer is None else str(peer))
        with c:
            gen = b["gen"]
            if not (isinstance(token, str) and token in b["arrived"]):
                b["arrived"].append(token)
            c.notify_all()

            def live_count():
                if alive_fn is None:
                    return len(b["arrived"])
                return sum(1 for p in b["arrived"]
                           if not isinstance(p, str) or alive_fn(p))

            while b["gen"] == gen and \
                    live_count() < max(1, int(count_fn())):
                if deadline is not None and time.monotonic() > deadline:
                    err = BarrierTimeoutError(
                        name, self.endpoint, timeout,
                        list(b["arrived"]), max(1, int(count_fn())))
                    # withdraw our arrival: a stale token must not
                    # satisfy (and silently desync) a later generation
                    try:
                        b["arrived"].remove(token)
                    except ValueError:
                        pass
                    c.notify_all()
                    # flight-recorder trigger: a stalled barrier is a
                    # post-mortem moment — dump the causal event chain
                    # next to the one-line diagnostic
                    _flight.record(
                        "barrier", "timeout", name=name,
                        endpoint=self.endpoint,
                        arrived=len(err.arrived), needed=err.needed,
                        waiters=",".join(
                            p for p in err.arrived
                            if isinstance(p, str)))
                    _flight.dump(reason="barrier_timeout")
                    raise err
                c.wait(poll)
            me_alive = alive_fn is None or not isinstance(token, str) \
                or alive_fn(token)
            if b["gen"] == gen:
                # first waiter to observe completion advances the
                # generation and releases everyone else
                b["gen"] += 1
                b["arrived"] = []
                b["leader_taken"] = False
                _flight.record("barrier", "release", name=name,
                               endpoint=self.endpoint, gen=gen)
                c.notify_all()
            if me_alive and not b["leader_taken"] and \
                    b["gen"] == gen + 1:
                b["leader_taken"] = True
                return 0
            return 1

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def _accept_loop(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            _no_delay(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _dispatch(self, msg):
        """(msg_type, payload) -> ("ok", reply) | ("error", text).
        One dispatch semantics for every transport framing.

        Exactly-once envelope: a payload shaped
        (_DEDUP_TAG, client_id, seq, inner) is unwrapped here; if
        (client_id, seq) already executed, the cached ok-reply is
        returned WITHOUT re-running the handler — a retried send_var
        whose reply was lost lands once, not twice.  Handlers only ever
        see the inner payload.

        Trace envelope: (_TRACE_TAG, trace_id, span_id, inner) is
        unwrapped FIRST (it wraps the dedup envelope); when this
        process traces, the handler runs under a span parented on the
        caller's ids — the pserver side of one distributed trace."""
        import time

        if not (isinstance(msg, tuple) and len(msg) == 2
                and isinstance(msg[0], str)):
            return ("error", "message must be (msg_type, payload)")
        msg_type, payload = msg
        fn = self._handlers.get(msg_type)
        if fn is None:
            return ("error", f"no handler for '{msg_type}'")
        tctx = None
        if (isinstance(payload, tuple) and len(payload) == 4
                and payload[0] == _TRACE_TAG):
            tctx = (payload[1], payload[2])
            payload = payload[3]
        dedup_key = None
        if (isinstance(payload, tuple) and len(payload) == 4
                and payload[0] == _DEDUP_TAG):
            dedup_key = (payload[1], payload[2])
            payload = payload[3]
            with self._dedup_lock:
                cached = self._dedup.get(dedup_key)
                if cached is not None:
                    self._dedup.move_to_end(dedup_key)
                    return cached
        t0 = time.perf_counter()
        try:
            if _trace._tracer is not None and \
                    msg_type not in _UNTRACED_MSG_TYPES:
                with _trace._tracer.span("rpc.server:" + msg_type,
                                         parent=tctx,
                                         endpoint=self.endpoint):
                    reply = ("ok", fn(payload))
            else:
                reply = ("ok", fn(payload))
        except Exception as e:  # surface to client
            _M_SRV_REQS.inc(msg_type=msg_type, status="error")
            return ("error", repr(e))
        _M_SRV_REQS.inc(msg_type=msg_type, status="ok")
        _M_SRV_SECONDS.observe(time.perf_counter() - t0,
                               msg_type=msg_type)
        if dedup_key is not None:
            with self._dedup_lock:
                self._dedup[dedup_key] = reply
                while len(self._dedup) > _DEDUP_CACHE_SIZE:
                    self._dedup.popitem(last=False)
        return reply

    def _serve_conn(self, conn):
        try:
            while not self._stop.is_set():
                try:
                    msg = _recv_msg(conn)
                except (ConnectionError, EOFError, OSError):
                    return
                except WireError as e:
                    # frame was fully consumed (length-prefixed), so the
                    # stream is still in sync: report and keep serving
                    _send_msg(conn, ("error", f"bad wire frame: {e}"))
                    continue
                fault = None
                inj = faultinject.maybe_injector()
                if inj is not None and isinstance(msg, tuple) \
                        and len(msg) == 2 and isinstance(msg[0], str):
                    fault = inj.decide(msg[0])
                if fault is not None:
                    steps = faultinject.steps_of(fault)
                    if steps[0][0] in ("close", "kill"):
                        # request-loss: handler never runs (kill = the
                        # handler thread crashed at entry)
                        return
                    reply = self._dispatch(msg)
                    # chains apply in order: delays run first (after
                    # the handler), then at most one terminal step
                    done = False
                    for kind, arg in steps:
                        if kind == "delay":
                            import time
                            time.sleep(arg)
                        elif kind == "drop":
                            done = True  # reply-loss: executed,
                            break        # reply discarded
                        elif kind == "truncate":
                            try:
                                data = wire_dumps(reply)
                                frame = _LEN.pack(len(data)) + data
                                conn.sendall(
                                    frame[:max(1, int(len(frame)
                                                      * arg))])
                            except (WireError, OSError):
                                pass
                            done = True  # mid-frame close
                            break
                    if done:
                        return
                else:
                    reply = self._dispatch(msg)
                try:
                    _send_msg(conn, reply)
                except WireError as e:
                    # handler returned something non-encodable: tell the
                    # client instead of killing the connection
                    _send_msg(conn, ("error",
                                     f"reply not wire-encodable: {e}"))
        finally:
            conn.close()

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


class RPCClient:
    """Per-endpoint persistent connections (reference grpc_client.h:176
    channel cache); thread-safe via per-connection locks.

    Failure semantics (reference grpc_client deadline/retry loops):
    every call() runs under a deadline; transport failures on msg types
    classified idempotent retry transparently with exponential backoff
    + jitter; non-idempotent types (IDEMPOTENT_UNSAFE) carry a
    (client_id, seq) envelope the server dedups, making their retries
    exactly-once.  Unclassified types never retry.  A per-endpoint
    circuit breaker fails fast after consecutive terminal failures.

    Env knobs (all optional; see docs/FAULT_TOLERANCE.md):
      PADDLE_TPU_RPC_DEADLINE      per-call budget incl. retries (120s)
      PADDLE_TPU_RPC_RETRIES       max transparent retries (5; 0 = off,
                                   exact pre-retry wire + behavior)
      PADDLE_TPU_RPC_BACKOFF       first backoff (0.05s; doubles, 2s
                                   cap, +/-50% jitter)
      PADDLE_TPU_RPC_CB_THRESHOLD  breaker opens after N consecutive
                                   terminal failures (8; 0 = disabled)
      PADDLE_TPU_RPC_CB_COOLDOWN   breaker open time (1s)
    """

    _TIMEOUT = 120.0
    _RETRYABLE = _RETRYABLE_EXCS   # framings may widen (HTTP adds
    #                                http.client.HTTPException)

    # transparent-retry classification (the idempotence table in
    # docs/FAULT_TOLERANCE.md)
    IDEMPOTENT = frozenset({
        "get_var", "prefetch_rows", "heartbeat", "health",
        "live_trainers", "dead_trainers", "init_done", "init_wait",
        "checkpoint_notify", "checkpoint_restore", "reregister",
    })
    # non-idempotent but retry-safe through the server-side dedup
    # cache.  Barriers are here on purpose: a retried barrier whose
    # ORIGINAL released must get the cached release reply — a fresh
    # arrival would land one generation late and let the next round's
    # grad merge run before this trainer's push (parity loss).  The
    # server-side same-peer arrival dedup in barrier_dynamic is the
    # second line of defense for non-enveloped re-invocations.
    IDEMPOTENT_UNSAFE = frozenset({
        "send_var", "send_sparse", "complete", "send_barrier",
        "fetch_barrier",
    })

    def __init__(self):
        self._conns: dict = {}
        self._locks: dict = {}
        self._global_lock = threading.Lock()
        self._client_id = uuid.uuid4().hex
        self._seq = itertools.count(1)
        self._DEADLINE = None       # per-instance override of the env
        self._breaker: dict = {}    # endpoint -> [consec_fails, open_until]

    def _stat(self, endpoint, **incs):
        """Counters live in the observability registry (labels
        client/endpoint); stats() is a VIEW over them — there is no
        second private copy to drift."""
        for k, v in incs.items():
            _M_CLIENT[k].inc(v, client=self._client_id,
                             endpoint=endpoint)

    def stats(self):
        """Per-endpoint client-side failure telemetry — the breaker
        state the fault-tolerance round left invisible, plus retry and
        deadline-miss counts.  Shape (per endpoint):

            {"calls": N, "retries": N, "deadline_misses": N,
             "failures": N, "breaker": {"consecutive_failures": N,
             "open": bool, "cooldown_remaining_s": float}}

        ``failures`` counts TERMINAL call failures (retries exhausted /
        deadline blown / breaker trip), not absorbed transient ones.

        This is a read-through VIEW over the process metrics registry
        (paddle_tpu_rpc_client_*_total filtered to this client's
        label), so it can never drift from /metrics."""
        import time

        thresh = _env_int("PADDLE_TPU_RPC_CB_THRESHOLD", 8)
        now = time.monotonic()
        out: dict = {}
        for key, metric in _M_CLIENT.items():
            for labels, value in metric.items():
                if labels.get("client") != self._client_id:
                    continue
                ep = labels.get("endpoint")
                out.setdefault(ep, {"calls": 0, "retries": 0,
                                    "deadline_misses": 0,
                                    "failures": 0})[key] = int(value)
        for ep in set(out) | set(self._breaker):
            st = self._breaker.get(ep)
            out.setdefault(ep, {"calls": 0, "retries": 0,
                                "deadline_misses": 0, "failures": 0})
            out[ep]["breaker"] = {
                "consecutive_failures": st[0] if st else 0,
                "open": bool(st and thresh > 0 and st[0] >= thresh
                             and now < st[1]),
                "cooldown_remaining_s": max(0.0, st[1] - now)
                if st else 0.0,
            }
        return out

    def _connect(self, endpoint, timeout=None):
        """Blocking connect with retry (the server may not be up yet —
        reference wait_server_ready polls the port the same way)."""
        import time

        timeout = self._TIMEOUT if timeout is None else timeout
        host, port = endpoint.rsplit(":", 1)
        deadline = time.monotonic() + timeout
        while True:
            try:
                s = socket.create_connection((host, int(port)),
                                             timeout=timeout)
                break
            except (ConnectionRefusedError, OSError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        s.settimeout(timeout)
        _no_delay(s)
        return s

    def _get_conn(self, endpoint, timeout=None):
        # connect-retry happens under the PER-ENDPOINT lock only: one
        # dead endpoint retrying for up to _TIMEOUT must not stall this
        # client's RPCs to every other (healthy) endpoint
        with self._global_lock:
            conn = self._conns.get(endpoint)
            lock = self._locks.setdefault(endpoint, threading.Lock())
            if conn is not None:
                return conn, lock
        with lock:
            with self._global_lock:
                conn = self._conns.get(endpoint)
                if conn is not None:
                    return conn, lock
            conn = self._connect(endpoint, timeout=timeout)
            with self._global_lock:
                self._conns[endpoint] = conn
            return conn, lock

    def _evict(self, endpoint, conn):
        """Drop (and close) a broken cached connection so the next call
        reconnects (e.g. a pserver restart in the elastic path); the
        per-endpoint lock object persists — recreating it would let a
        concurrent holder of the old lock race the new one."""
        with self._global_lock:
            cached = self._conns.get(endpoint)
            if cached is conn:
                try:
                    cached.close()
                except OSError:
                    pass
                del self._conns[endpoint]

    def _set_attempt_timeout(self, conn, timeout):
        conn.settimeout(timeout)

    def _call_once(self, endpoint, msg_type, payload, timeout):
        """One request/reply exchange.  Any transport failure — refused,
        reset, a socket timeout mid-_recv_exact (which leaves a
        half-read frame on the cached connection), or a WireError from
        a garbled reply — EVICTS the connection: reusing it would read
        the previous call's late bytes as this call's reply and desync
        the wire for every call after."""
        conn, lock = self._get_conn(endpoint, timeout=timeout)
        try:
            with lock:
                self._set_attempt_timeout(conn, timeout)
                _send_msg(conn, (msg_type, payload))
                status, reply = _recv_msg(conn)
        except (ConnectionError, TimeoutError, OSError, WireError):
            self._evict(endpoint, conn)
            raise
        self._breaker_ok(endpoint)
        if status == "error":
            raise RuntimeError(
                f"RPC '{msg_type}' to {endpoint} failed: {reply}")
        return reply

    # -- circuit breaker (per endpoint, consecutive terminal failures) ------
    def _breaker_gate(self, endpoint):
        import time

        thresh = _env_int("PADDLE_TPU_RPC_CB_THRESHOLD", 8)
        if thresh <= 0:
            return
        st = self._breaker.get(endpoint)
        if st and st[0] >= thresh:
            now = time.monotonic()
            if now < st[1]:
                raise CircuitOpenError(
                    f"circuit open for {endpoint}: {st[0]} consecutive "
                    f"call failures; retry in {st[1] - now:.2f}s")
            # half-open: let this probe through, push the window so
            # concurrent callers don't stampede the recovering server
            st[1] = now + _env_float("PADDLE_TPU_RPC_CB_COOLDOWN", 1.0)

    def _breaker_ok(self, endpoint):
        self._breaker.pop(endpoint, None)

    def _breaker_fail(self, endpoint):
        import time

        st = self._breaker.setdefault(endpoint, [0, 0.0])
        st[0] += 1
        st[1] = time.monotonic() + \
            _env_float("PADDLE_TPU_RPC_CB_COOLDOWN", 1.0)
        thresh = _env_int("PADDLE_TPU_RPC_CB_THRESHOLD", 8)
        if thresh > 0 and st[0] == thresh:
            # open TRANSITION (not every failure beyond it): a metric
            # + a flight-recorder event — the "breaker invisible" gap
            _M_BREAKER_OPENS.inc(endpoint=endpoint)
            _flight.record("rpc", "breaker_open", endpoint=endpoint,
                           consecutive_failures=st[0])

    def call(self, endpoint: str, msg_type: str, payload=None,
             deadline=None, retries=None):
        """Request/reply with deadline + idempotence-aware retry.

        deadline: total budget in seconds for this call INCLUDING
        retries (None -> instance override -> PADDLE_TPU_RPC_DEADLINE
        -> _TIMEOUT).  retries: max transparent retries on transport
        failure (None -> PADDLE_TPU_RPC_RETRIES, default 5); only
        msg types in IDEMPOTENT retry as-is, IDEMPOTENT_UNSAFE types
        retry under the exactly-once dedup envelope, and unclassified
        types never retry unless `retries` is passed explicitly.
        Handler errors raise RuntimeError and are never retried."""
        import random
        import time

        if deadline is None:
            deadline = self._DEADLINE if self._DEADLINE is not None \
                else _env_float("PADDLE_TPU_RPC_DEADLINE", self._TIMEOUT)
        explicit_retries = retries is not None
        if retries is None:
            retries = _env_int("PADDLE_TPU_RPC_RETRIES", 5)
        if msg_type in self.IDEMPOTENT_UNSAFE and retries > 0:
            payload = (_DEDUP_TAG, self._client_id,
                       next(self._seq), payload)
        elif msg_type not in self.IDEMPOTENT and not explicit_retries:
            retries = 0
        span = None
        if _trace._tracer is not None and \
                msg_type not in _UNTRACED_MSG_TYPES:
            # the distributed-trace envelope: the server-side handler
            # span joins THIS trace id (one conditional when off).
            # Head sampling: a dropped trace sends NO
            # envelope — the wire is byte-identical to flag-off, and
            # the server never sees a partial trace
            span = _trace._tracer.start_span(
                "rpc.client:" + msg_type, endpoint=endpoint)
            if span.sampled:
                payload = (_TRACE_TAG, span.trace_id, span.span_id,
                           payload)
        try:
            try:
                self._breaker_gate(endpoint)
            except CircuitOpenError:
                self._stat(endpoint, calls=1, failures=1)
                raise
            self._stat(endpoint, calls=1)
            deadline_t = time.monotonic() + float(deadline)
            backoff = _env_float("PADDLE_TPU_RPC_BACKOFF", 0.05)
            attempt = 0
            while True:
                budget = deadline_t - time.monotonic()
                if budget <= 0:
                    self._breaker_fail(endpoint)
                    self._stat(endpoint, deadline_misses=1, failures=1)
                    _flight.record("rpc", "deadline_exceeded",
                                   msg_type=msg_type,
                                   endpoint=endpoint, attempts=attempt)
                    raise RPCDeadlineExceeded(
                        f"RPC '{msg_type}' to {endpoint}: deadline "
                        f"{deadline:g}s exhausted after {attempt} "
                        "attempts")
                try:
                    return self._call_once(endpoint, msg_type, payload,
                                           min(budget, self._TIMEOUT))
                except self._RETRYABLE as e:
                    attempt += 1
                    if attempt > retries:
                        self._breaker_fail(endpoint)
                        self._stat(endpoint, failures=1,
                                   deadline_misses=int(
                                       isinstance(e, socket.timeout)))
                        _flight.record("rpc", "call_failed",
                                       msg_type=msg_type,
                                       endpoint=endpoint,
                                       attempts=attempt,
                                       error=type(e).__name__)
                        raise
                    self._stat(endpoint, retries=1)
                    _flight.record("rpc", "retry", msg_type=msg_type,
                                   endpoint=endpoint, attempt=attempt,
                                   error=type(e).__name__)
                    sleep = min(backoff * (2 ** (attempt - 1)), 2.0) \
                        * (0.5 + random.random())
                    if time.monotonic() + sleep >= deadline_t:
                        self._breaker_fail(endpoint)
                        self._stat(endpoint, deadline_misses=1,
                                   failures=1)
                        _flight.record("rpc", "deadline_exceeded",
                                       msg_type=msg_type,
                                       endpoint=endpoint,
                                       attempts=attempt)
                        raise RPCDeadlineExceeded(
                            f"RPC '{msg_type}' to {endpoint}: deadline "
                            f"{deadline:g}s exhausted after {attempt} "
                            f"attempts (last: {e!r})") from e
                    time.sleep(sleep)
        except Exception as e:
            if span is not None:
                span.set_attr("error", type(e).__name__)
            raise
        finally:
            if span is not None:
                span.end()

    def health(self, endpoint, deadline=2.0):
        """Probe the server's built-in 'health' handler: short deadline,
        no retries — the caller decides what unhealthy means."""
        return self.call(endpoint, "health", deadline=deadline,
                         retries=0)

    # reference rpc_client.h API names
    def send_var(self, endpoint, name, value, trainer_idx=None):
        """trainer_idx (int) identifies the sender — DC-ASGD pservers
        use it to pick the per-trainer param backup."""
        if trainer_idx is None:
            return self.call(endpoint, "send_var", (name, value))
        return self.call(endpoint, "send_var",
                         (name, value, int(trainer_idx)))

    def get_var(self, endpoint, name, trainer_idx=None):
        if trainer_idx is None:
            return self.call(endpoint, "get_var", name)
        return self.call(endpoint, "get_var", (name, int(trainer_idx)))

    def send_barrier(self, endpoint, peer_id=None):
        return self.call(endpoint, "send_barrier", peer_id)

    def fetch_barrier(self, endpoint, peer_id=None):
        return self.call(endpoint, "fetch_barrier", peer_id)

    def send_complete(self, endpoint, peer_id=None):
        """Notify trainer completion (reference Executor::Close
        SendComplete).  peer_id lets the pserver retire this trainer
        from its liveness accounting instead of later declaring the
        (now silent) trainer dead.  Only the COMPLETING peer's
        heartbeat sender is stopped — with peer_id=None none are (a
        co-hosted peer still training must keep beating); daemon
        senders die with the process anyway."""
        if peer_id is not None:
            stop_shared_heartbeats(endpoint=endpoint, peer_id=peer_id)
        return self.call(endpoint, "complete", peer_id)

    def close(self):
        with self._global_lock:
            for s in self._conns.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._conns.clear()
            self._locks.clear()


def _transport():
    import os

    return os.environ.get("PADDLE_TPU_RPC_TRANSPORT", "socket")


def make_rpc_server(endpoint: str) -> "RPCServer":
    """Transport-selected server (reference: gRPC vs BRPC behind one
    RPCServer abstraction, chosen by WITH_BRPC at build time; here
    PADDLE_TPU_RPC_TRANSPORT=socket|http at run time)."""
    if _transport() == "http":
        from paddle_tpu_torch.distributed.http_transport import HTTPRPCServer

        return HTTPRPCServer(endpoint)
    return RPCServer(endpoint)


def make_rpc_client() -> "RPCClient":
    if _transport() == "http":
        from paddle_tpu_torch.distributed.http_transport import HTTPRPCClient

        return HTTPRPCClient()
    return RPCClient()


_global_client = None
_client_lock = threading.Lock()


def global_rpc_client() -> RPCClient:
    global _global_client
    with _client_lock:
        if _global_client is None:
            _global_client = make_rpc_client()
        return _global_client


class HeartbeatMonitor:
    """Liveness tracking over the RPC control plane (the failure-detection
    half the reference keeps minimal — retries + complete-notify; this
    adds the elastic-training primitive: per-peer heartbeats with a
    deadline, reference analog: fleet elastic heartbeat loops).

    Server side: monitor = HeartbeatMonitor(timeout); server.register_handler
    ("heartbeat", monitor.beat).  Client side:
    HeartbeatSender(None, endpoint, peer_id).start() spawns a daemon
    thread beating every interval seconds.
    """

    def __init__(self, timeout=10.0):
        self.timeout = float(timeout)
        self._last_seen: dict = {}
        self._lock = threading.Lock()

    def beat(self, peer_id):
        import time

        with self._lock:
            self._last_seen[str(peer_id)] = time.monotonic()
        return len(self._last_seen)

    def peers(self):
        with self._lock:
            return sorted(self._last_seen)

    def live_peers(self):
        import time

        now = time.monotonic()
        with self._lock:
            return sorted(p for p, t in self._last_seen.items()
                          if now - t <= self.timeout)

    def dead_peers(self):
        import time

        now = time.monotonic()
        with self._lock:
            return sorted(p for p, t in self._last_seen.items()
                          if now - t > self.timeout)

    def forget(self, peer_id):
        with self._lock:
            self._last_seen.pop(str(peer_id), None)


class HeartbeatSender:
    """Daemon thread beating a server's 'heartbeat' handler (client half
    of HeartbeatMonitor).

    client=None (recommended) uses a DEDICATED short-timeout RPCClient so
    a stuck beat can never hold a shared client's connection locks and
    stall foreground RPCs."""

    def __init__(self, client, endpoint, peer_id, interval=1.0):
        if client is None:
            client = make_rpc_client()
            client._TIMEOUT = max(2.0, 2 * float(interval))
            # per-instance deadline beats any PADDLE_TPU_RPC_DEADLINE:
            # a beat must never hold its dedicated client for minutes
            client._DEADLINE = client._TIMEOUT
            self._owns_client = True
        else:
            self._owns_client = False
        self._client = client
        self._endpoint = endpoint
        self._peer_id = str(peer_id)
        self._interval = float(interval)
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            if not self._stop.is_set():
                return self  # genuinely running: idempotent
            # a previous stop() timed out mid-beat: wait the old loop
            # out before spawning, or heartbeats would silently never
            # resume once it exits
            self._thread.join()
        self._stop.clear()  # restartable after stop()

        def loop():
            while not self._stop.is_set():
                try:
                    self._client.call(self._endpoint, "heartbeat",
                                      self._peer_id)
                except Exception:
                    pass  # server down: the monitor times us out anyway
                self._stop.wait(self._interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._interval + 1.0)
        if self._owns_client:
            self._client.close()


# -- shared sender registry (one daemon per (endpoint, peer_id)) ----------
_shared_senders: dict = {}
_shared_senders_lock = threading.Lock()


def start_shared_heartbeat(endpoint, peer_id, interval=1.0):
    """Idempotent process-wide HeartbeatSender registry (used by the
    trainer program's heartbeat_start op): one daemon per (endpoint,
    peer_id), stoppable via stop_shared_heartbeats so completed jobs
    don't leak threads that retry dead endpoints forever."""
    key = (endpoint, str(peer_id))
    with _shared_senders_lock:
        s = _shared_senders.get(key)
        if s is None:
            s = _shared_senders[key] = HeartbeatSender(
                None, endpoint, peer_id, interval=interval)
        s.start()
        return s


def stop_shared_heartbeats(endpoint=None, peer_id=None):
    """Stop (and drop) shared senders — all, one endpoint's, or one
    (endpoint, peer) pair's.  Called automatically by
    RPCClient.send_complete with the completing peer only, so other
    peers hosted in the same process keep beating."""
    peer_id = None if peer_id is None else str(peer_id)
    with _shared_senders_lock:
        keys = [k for k in _shared_senders
                if (endpoint is None or k[0] == endpoint)
                and (peer_id is None or k[1] == peer_id)]
        senders = [_shared_senders.pop(k) for k in keys]
    for s in senders:
        s.stop()
