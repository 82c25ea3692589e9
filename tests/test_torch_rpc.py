"""The port's RPC transport (paddle_tpu_torch/distributed/rpc.py and
http_transport.py) against the JAX package's.

The wire is a byte-level contract: ``wire_dumps`` of either package gives
the same bytes for every payload here, each package's ``wire_loads``
reads the other's, and clients and servers of the two packages talk to
each other over both framings.  The rejections of tests/test_rpc_wire.py
and the fault-plan cases of tests/test_fault_tolerance.py rerun over the
port, on the socket and the HTTP framing, with the port's own fault
injector (the one its servers consult).
"""

import importlib.util
import os
import pickle
import socket as socket_mod
import struct
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import http_transport as jax_http
from paddle_tpu.distributed import rpc as jax_rpc
from paddle_tpu_torch.distributed import faultinject
from paddle_tpu_torch.distributed import http_transport as pt_http
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.distributed.faultinject import FaultPlan
from paddle_tpu_torch.distributed.rpc import (BarrierTimeoutError,
                                              CircuitOpenError, RPCClient,
                                              RPCDeadlineExceeded, RPCServer,
                                              WireError, wire_dumps,
                                              wire_loads)

SCALARS = [
    None, True, False, 0, 42, -2**63, 2**63 - 1, 3.14, -0.0, "héllo", b"",
    b"\x00\xff", [], (), {}, [1, [2, [3]]], ("a", ("b",)),
    {"k": 1, 2: "v", None: True},
]

ARRAYS = [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.array(5, dtype=np.int64),                       # 0-d stays 0-d
    np.zeros((0, 3), np.float64),                      # empty
    np.ones((2, 2), np.float16),
    np.array([True, False]),
    np.arange(6).reshape(2, 3).T,                      # non-contiguous
    np.arange(5, dtype=np.int32), np.arange(4, dtype=np.uint8),
    np.arange(3, dtype=np.int8), np.arange(3, dtype=np.complex64),
    np.arange(4, dtype=">f4"),                         # big-endian
    np.array([b"ab", b"c"]), np.array(["ab", "c"]),
    np.float32(2.5), np.float64(2.5),                  # numpy scalars
    np.random.RandomState(0).rand(300, 7).astype(np.float32),
]

MESSAGES = [
    ("send_var", ("w0", np.random.RandomState(0).rand(10, 4)
                  .astype(np.float32))),
    ("get_var", ("w0.block1", 3)),
    ("__seq1__", "ab" * 16, 7, ("w", np.ones(3, np.float32), 1)),
    ("__trace1__", "0123456789abcdef", "12", ("send_barrier", "trainer0")),
    ("collector_push", {"process": "p", "seq": 1, "spans": [
        {"trace_id": "t", "span_id": "1", "parent_id": None,
         "attrs": {"endpoint": "127.0.0.1:1"}}], "metrics": {}}),
]


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("obj", SCALARS + ARRAYS + MESSAGES,
                         ids=lambda o: type(o).__name__)
def test_wire_bytes_equal_jax_and_each_reads_the_other(obj):
    data = wire_dumps(obj)
    assert data == jax_rpc.wire_dumps(obj)
    assert _same(wire_loads(data), obj)
    assert _same(jax_rpc.wire_loads(data), obj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64,
                                   torch.float16, torch.bool])
def test_torch_tensor_goes_as_its_numpy_bytes(dtype):
    t = torch.arange(12).reshape(3, 4).to(dtype)
    data = wire_dumps(("send_var", ("w", t.t())))   # a strided view too
    assert data == jax_rpc.wire_dumps(("send_var", ("w", t.t().numpy())))
    out = jax_rpc.wire_loads(data)[1][1]
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, t.t().numpy())


def test_int_overflow_rejected():
    with pytest.raises(WireError):
        wire_dumps(2**64)


@pytest.mark.parametrize("bad", [
    b"", b"z", b"i\x00",
    b"a" + struct.pack("!I", 0x30) + b"x" * 0x30,      # junk dtype
    wire_dumps(1) + b"extra",                          # trailing bytes
])
def test_malformed_rejected(bad):
    with pytest.raises(WireError):
        wire_loads(bad)


def test_pickle_payload_rejected():
    with pytest.raises(WireError):
        wire_loads(pickle.dumps(("send_var", ("w", np.ones(2)))))


def test_code_like_objects_not_encodable():
    for obj in (object(), lambda: 1, {1, 2}, type):
        with pytest.raises(WireError):
            wire_dumps(obj)


def test_ndarray_header_payload_mismatch_rejected():
    hdr = bytearray(wire_dumps(np.ones(4, np.float32)))
    hdr[-17] ^= 0x01
    with pytest.raises(WireError):
        wire_loads(bytes(hdr))


def test_structured_dtype_rejected():
    with pytest.raises(WireError):
        wire_dumps(np.zeros(3, dtype=[("a", "f4"), ("b", "i4")]))


def test_cyclic_and_deep_payloads_fail_at_sender():
    cyc = []
    cyc.append(cyc)
    with pytest.raises(WireError):
        wire_dumps(cyc)
    deep = 0
    for _ in range(40):
        deep = [deep]
    with pytest.raises(WireError):
        wire_dumps(deep)


def test_large_array_round_trip_over_the_socket():
    """A frame of tens of MB arrives in many chunks into one buffer."""
    server = RPCServer("127.0.0.1:0").start()
    server.register_handler("echo", lambda p: p)
    client = RPCClient()
    try:
        big = np.random.RandomState(2).rand(3_000_000).astype(np.float32)
        out = client.call(server.endpoint, "echo", ("w", big), retries=0)
        assert out[0] == "w" and np.array_equal(out[1], big)
    finally:
        client.close()
        server.stop()


def test_server_survives_bad_frames_and_bad_replies():
    server = RPCServer("127.0.0.1:0").start()
    server.register_handler("ok", lambda p: p)
    server.register_handler("bad_reply", lambda p: {1, 2, 3})
    try:
        host, port = server.endpoint.rsplit(":", 1)
        s = socket_mod.create_connection((host, int(port)), timeout=10)
        s.settimeout(10)

        def read(n):
            buf = b""
            while len(buf) < n:
                c = s.recv(n - len(buf))
                assert c, "server closed connection"
                buf += c
            return buf

        def call_raw(data):
            s.sendall(struct.pack("!Q", len(data)) + data)
            n, = struct.unpack("!Q", read(8))
            return wire_loads(read(n))

        status, msg = call_raw(b"\xff garbage")
        assert status == "error" and "bad wire frame" in msg
        status, msg = call_raw(wire_dumps("just-a-string"))
        assert status == "error"
        status, msg = call_raw(wire_dumps(("bad_reply", None)))
        assert status == "error" and "not wire-encodable" in msg
        status, msg = call_raw(wire_dumps(("ok", 7)))
        assert status == "ok" and msg == 7
        s.close()
    finally:
        server.stop()


def test_heartbeat_monitor_liveness():
    server = RPCServer("127.0.0.1:0").start()
    mon = rpc.HeartbeatMonitor(timeout=0.8)
    server.register_handler("heartbeat", mon.beat)
    try:
        client = RPCClient()
        hb1 = rpc.HeartbeatSender(client, server.endpoint, "trainer0",
                                  interval=0.2).start()
        hb2 = rpc.HeartbeatSender(client, server.endpoint, "trainer1",
                                  interval=0.2).start()

        def until(cond, deadline=8.0):
            end = time.time() + deadline
            while time.time() < end and not cond():
                time.sleep(0.1)
            return cond()

        assert until(lambda: mon.live_peers() == ["trainer0", "trainer1"])
        hb1.stop()
        assert until(lambda: mon.dead_peers() == ["trainer0"])
        assert until(lambda: "trainer1" in mon.live_peers())
        mon.forget("trainer0")
        assert mon.peers() == ["trainer1"]
        hb2.stop()
        client.close()
    finally:
        server.stop()


def test_shared_heartbeats_start_once_and_stop_by_peer():
    server = RPCServer("127.0.0.1:0").start()
    mon = rpc.HeartbeatMonitor(timeout=5.0)
    server.register_handler("heartbeat", mon.beat)
    server.register_handler("complete", lambda p: p)
    try:
        a = rpc.start_shared_heartbeat(server.endpoint, "t0", interval=0.1)
        assert rpc.start_shared_heartbeat(server.endpoint, "t0",
                                          interval=0.1) is a
        rpc.start_shared_heartbeat(server.endpoint, "t1", interval=0.1)
        end = time.time() + 5.0
        while time.time() < end and mon.live_peers() != ["t0", "t1"]:
            time.sleep(0.05)
        assert mon.live_peers() == ["t0", "t1"]
        client = RPCClient()
        assert client.send_complete(server.endpoint, peer_id="t0") == "t0"
        assert sorted(k[1] for k in rpc._shared_senders) == ["t1"]
        client.close()
    finally:
        rpc.stop_shared_heartbeats()
        server.stop()


# ---------------------------------------------------------------------------
# the fault-plan cases, over both framings
# ---------------------------------------------------------------------------

def _free_port():
    s = socket_mod.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(params=["socket", "http"])
def transport(request):
    if request.param == "socket":
        server, client = RPCServer("127.0.0.1:0"), RPCClient()
    else:
        server, client = (pt_http.HTTPRPCServer("127.0.0.1:0"),
                          pt_http.HTTPRPCClient())
    server.start()
    yield server, client
    faultinject.uninstall()
    server.stop()
    client.close()


def test_make_rpc_server_and_client_follow_the_transport_knob(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RPC_TRANSPORT", "http")
    server = rpc.make_rpc_server("127.0.0.1:0")
    client = rpc.make_rpc_client()
    assert isinstance(server, pt_http.HTTPRPCServer)
    assert isinstance(client, pt_http.HTTPRPCClient)
    server.stop()
    monkeypatch.setenv("PADDLE_TPU_RPC_TRANSPORT", "socket")
    server = rpc.make_rpc_server("127.0.0.1:0")
    assert type(server) is RPCServer and \
        type(rpc.make_rpc_client()) is RPCClient
    server.stop()


def test_combined_delay_then_truncate_on_wire(transport):
    server, client = transport
    server.register_handler("echo", lambda p: p)
    plan = FaultPlan().on("echo", 0, "delay=0.25+truncate")
    with faultinject.installed(plan) as inj:
        t0 = time.monotonic()
        out = client.call(server.endpoint, "echo",
                          {"k": np.arange(6.0)}, retries=3)
        assert time.monotonic() - t0 >= 0.25
    assert out["k"][5] == 5.0
    assert inj.log == [("echo", 0, "delay+truncate")]
    for i in range(3):
        assert client.call(server.endpoint, "echo", i) == i


def test_rpc_client_stats_expose_breaker_retries_deadline(transport):
    server, client = transport
    server.register_handler("echo", lambda p: p)
    with faultinject.installed(FaultPlan().on("echo", 0, "drop")):
        assert client.call(server.endpoint, "echo", 1, retries=3) == 1
    st = client.stats()[server.endpoint]
    assert st["calls"] >= 1 and st["retries"] >= 1
    assert st["failures"] == 0
    assert st["breaker"] == {"consecutive_failures": 0, "open": False,
                             "cooldown_remaining_s": 0.0}
    with faultinject.installed(FaultPlan().on("echo", 0, "delay=1.0")):
        with pytest.raises(OSError):
            client.call(server.endpoint, "echo", "x", deadline=0.25,
                        retries=0)
    st = client.stats()[server.endpoint]
    assert st["deadline_misses"] >= 1 and st["failures"] >= 1
    assert st["breaker"]["consecutive_failures"] >= 1


def test_drop_reply_retried_idempotent(transport):
    server, client = transport
    calls = []
    server.register_handler("echo", lambda p: calls.append(p) or p)
    with faultinject.installed(FaultPlan().on("echo", 0, "drop")) as inj:
        out = client.call(server.endpoint, "echo", 41, retries=3)
    assert out == 41
    assert calls == [41, 41]
    assert inj.log == [("echo", 0, "drop")]


def test_send_var_exactly_once_under_reply_loss(transport):
    server, client = transport
    calls = []
    server.register_handler("send_var",
                            lambda p: calls.append(p) or "applied")
    with faultinject.installed(FaultPlan().on("send_var", 0, "drop")):
        out = client.send_var(server.endpoint, "w", np.ones(2))
    assert out == "applied"
    assert len(calls) == 1
    assert calls[0][0] == "w"
    np.testing.assert_array_equal(calls[0][1], np.ones(2))


def test_send_var_exactly_once_under_request_loss(transport):
    server, client = transport
    calls = []
    server.register_handler("send_var",
                            lambda p: calls.append(p) or "applied")
    with faultinject.installed(FaultPlan().on("send_var", 0, "close")):
        out = client.send_var(server.endpoint, "w", np.zeros(3))
    assert out == "applied" and len(calls) == 1


def test_truncated_reply_resyncs_connection(transport):
    server, client = transport
    server.register_handler("echo", lambda p: p)
    with faultinject.installed(FaultPlan().on("echo", 0, "truncate")):
        assert client.call(server.endpoint, "echo",
                           {"k": np.arange(5.0)}, retries=3)["k"][4] == 4.0
    for i in range(3):
        assert client.call(server.endpoint, "echo", i) == i


def test_kill_handler_retried(transport):
    server, client = transport
    calls = []
    server.register_handler("send_var", lambda p: calls.append(p) or "ok")
    with faultinject.installed(FaultPlan().on("send_var", 0, "kill")):
        assert client.send_var(server.endpoint, "w", np.ones(1)) == "ok"
    assert len(calls) == 1


def test_delayed_reply_past_deadline_does_not_desync(transport):
    server, client = transport
    server.register_handler("echo", lambda p: p)
    with faultinject.installed(FaultPlan().on("echo", 0, "delay=1.0")):
        with pytest.raises(OSError):
            client.call(server.endpoint, "echo", "STALE",
                        deadline=0.25, retries=0)
        assert server.endpoint not in client._conns
        out = client.call(server.endpoint, "echo", "FRESH", retries=0)
    assert out == "FRESH"


def test_delay_within_deadline_is_just_latency(transport):
    server, client = transport
    server.register_handler("echo", lambda p: p)
    with faultinject.installed(FaultPlan().on("echo", 0, "delay=0.2")):
        t0 = time.monotonic()
        assert client.call(server.endpoint, "echo", 5, retries=0) == 5
        assert time.monotonic() - t0 >= 0.2


def test_health_rpc(transport):
    server, client = transport
    server.register_handler("echo", lambda p: p)
    h = client.health(server.endpoint)
    assert h["status"] == "ok" and h["endpoint"] == server.endpoint
    assert "echo" in h["msg_types"] and "health" in h["msg_types"]


def test_retries_off_restores_seed_behavior(transport, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RPC_RETRIES", "0")
    server, client = transport
    seen = []
    server.register_handler("send_var", lambda p: seen.append(p) or "ok")
    with faultinject.installed(FaultPlan().on("send_var", 0, "drop")):
        with pytest.raises(Exception) as ei:
            client.send_var(server.endpoint, "w", np.ones(2))
    assert not isinstance(ei.value, RuntimeError)
    assert len(seen) == 1
    assert seen[0][0] == "w" and len(seen[0]) == 2


def test_handler_error_surfaces_and_is_not_retried(transport):
    server, client = transport
    calls = []

    def boom(p):
        calls.append(p)
        raise ValueError("nope")

    server.register_handler("get_var", boom)
    with pytest.raises(RuntimeError, match="nope"):
        client.get_var(server.endpoint, "w")
    assert calls == ["w"]


def test_dynamic_barrier_across_two_connections(transport):
    server, client = transport
    server.register_handler(
        "barrier", lambda p: server.barrier_dynamic("b", lambda: 2))
    other = type(client)()
    results = []

    def hit(cl):
        results.append(cl.call(server.endpoint, "barrier"))

    t = threading.Thread(target=hit, args=(other,))
    t.start()
    hit(client)
    t.join(timeout=10)
    other.close()
    assert sorted(results) == [0, 1]


def test_deadline_exceeded_raises_dedicated_error():
    client = RPCClient()
    t0 = time.monotonic()
    with pytest.raises(RPCDeadlineExceeded):
        client.call(f"127.0.0.1:{_free_port()}", "get_var", "w",
                    deadline=0.6, retries=8)
    assert 0.3 < time.monotonic() - t0 < 5.0
    client.close()


def test_circuit_breaker_fails_fast(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RPC_CB_THRESHOLD", "2")
    monkeypatch.setenv("PADDLE_TPU_RPC_CB_COOLDOWN", "30")
    client = RPCClient()
    dead = f"127.0.0.1:{_free_port()}"
    for _ in range(2):
        with pytest.raises(OSError):
            client.call(dead, "get_var", "w", deadline=0.3, retries=0)
    t0 = time.monotonic()
    with pytest.raises(CircuitOpenError):
        client.call(dead, "get_var", "w")
    assert time.monotonic() - t0 < 0.05
    assert client.stats()[dead]["breaker"]["open"]
    client.close()


def test_circuit_breaker_recovers_after_cooldown(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RPC_CB_THRESHOLD", "1")
    monkeypatch.setenv("PADDLE_TPU_RPC_CB_COOLDOWN", "0.2")
    server = RPCServer("127.0.0.1:0")
    server.register_handler("echo", lambda p: p)
    client = RPCClient()
    dead = f"127.0.0.1:{_free_port()}"
    with pytest.raises(OSError):
        client.call(dead, "get_var", "w", deadline=0.2, retries=0)
    with pytest.raises(CircuitOpenError):
        client.call(dead, "get_var", "w")
    time.sleep(0.25)
    server.start()
    assert client.call(server.endpoint, "echo", 1, retries=0) == 1
    server.stop()
    client.close()


def _tools_mod(name):
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_barrier_deadline_diagnostic_is_parseable():
    server = RPCServer("127.0.0.1:0")
    with pytest.raises(BarrierTimeoutError) as ei:
        server.barrier_dynamic("send", lambda: 3, poll=0.05,
                               peer="trainer0", timeout=0.3)
    msg = str(ei.value)
    assert "'send'" in msg and server.endpoint in msg
    assert "1/3 arrivals" in msg and "trainer0" in msg
    # the same one-line diagnostic as the JAX package's
    jax_msg = str(jax_rpc.BarrierTimeoutError(
        "send", server.endpoint, 0.3, ["trainer0"], 3))
    assert msg == jax_msg
    found = _tools_mod("check_test_hung").scan_barriers(
        [f"E   RuntimeError: {msg}"])
    assert found == [{"name": "send", "endpoint": server.endpoint,
                      "timeout_s": 0.3, "arrived": 1, "needed": 3,
                      "waiters": ["trainer0"]}]
    assert server._dyn_barriers["send"]["arrived"] == []
    server.stop()


def test_barrier_timeout_zero_means_no_deadline():
    server = RPCServer("127.0.0.1:0")
    done = []

    def other():
        done.append(server.barrier_dynamic("b0", lambda: 2, poll=0.02,
                                           peer="t1", timeout=0))

    th = threading.Thread(target=other, daemon=True)
    th.start()
    time.sleep(0.2)
    r = server.barrier_dynamic("b0", lambda: 2, poll=0.02, peer="t0",
                               timeout=0)
    th.join(timeout=5)
    assert sorted(done + [r]) == [0, 1]
    server.stop()


def test_barrier_duplicate_peer_arrival_is_deduped():
    server = RPCServer("127.0.0.1:0")
    results = []

    def arrive(peer):
        results.append(server.barrier_dynamic(
            "bd", lambda: 2, poll=0.02, peer=peer, timeout=10.0))

    t1 = threading.Thread(target=arrive, args=("t0",), daemon=True)
    t1.start()
    time.sleep(0.2)
    t2 = threading.Thread(target=arrive, args=("t0",), daemon=True)
    t2.start()
    time.sleep(0.3)
    assert results == []
    t3 = threading.Thread(target=arrive, args=("t1",), daemon=True)
    t3.start()
    for t in (t1, t2, t3):
        t.join(timeout=10)
    assert len(results) == 3 and sorted(results) == [0, 1, 1]
    server.stop()


def test_dropped_barrier_reply_returns_cached_release(transport):
    server, client = transport
    server.register_handler(
        "send_barrier",
        lambda peer: server.barrier_dynamic("sb", lambda: 2, poll=0.02,
                                            peer=peer, timeout=10.0))
    other = type(client)()
    results = []

    def arrive_other():
        results.append(other.call(server.endpoint, "send_barrier", "t1"))

    th = threading.Thread(target=arrive_other, daemon=True)
    with faultinject.installed(FaultPlan().on("send_barrier", 0, "drop")):
        th.start()
        time.sleep(0.2)
        r = client.send_barrier(server.endpoint, peer_id="t0")
        th.join(timeout=10)
    assert sorted(results + [r]) == [0, 1]
    assert server._dyn_barriers["sb"]["arrived"] == []
    other.close()


# ---------------------------------------------------------------------------
# the two packages on one wire, in one process
# ---------------------------------------------------------------------------

_PAIRS = {
    "socket": ((RPCServer, RPCClient),
               (jax_rpc.RPCServer, jax_rpc.RPCClient)),
    "http": ((pt_http.HTTPRPCServer, pt_http.HTTPRPCClient),
             (jax_http.HTTPRPCServer, jax_http.HTTPRPCClient)),
}


@pytest.mark.parametrize("framing", ["socket", "http"])
@pytest.mark.parametrize("server_of", ["port", "jax"])
def test_clients_and_servers_of_both_packages_interoperate(framing,
                                                           server_of):
    port, jax = _PAIRS[framing]
    (srv_cls, _), (_, cli_cls) = (port, jax) if server_of == "port" \
        else (jax, port)
    server = srv_cls("127.0.0.1:0")
    store = {}
    server.register_handler("send_var",
                            lambda p: store.__setitem__(p[0], p[1]))
    server.register_handler("get_var", lambda name: store[name])
    server.register_handler(
        "send_barrier", lambda peer: server.barrier_dynamic(
            "s", lambda: 1, peer=peer, timeout=10.0))
    server.start()
    client = cli_cls()
    try:
        w = np.random.RandomState(1).rand(8, 3).astype(np.float32)
        client.send_var(server.endpoint, "w", w)       # dedup envelope
        assert client.send_barrier(server.endpoint, "trainer0") == 0
        out = client.get_var(server.endpoint, "w")
        assert out.dtype == np.float32 and np.array_equal(out, w)
        h = client.health(server.endpoint)
        assert h["status"] == "ok" and "send_var" in h["msg_types"]
        with pytest.raises(RuntimeError):
            client.call(server.endpoint, "no_such_type", 1)
    finally:
        client.close()
        server.stop()


def test_traced_port_client_joins_a_jax_server_span():
    """The trace envelope crosses the packages: a JAX server's handler
    span is parented on the port client's span."""
    from paddle_tpu.observability import tracing as jax_tracing
    from paddle_tpu_torch.observability import tracing

    server = jax_rpc.RPCServer("127.0.0.1:0").start()
    server.register_handler("echo", lambda p: p)
    t_port = tracing.start_tracing(sample=1.0)
    t_jax = jax_tracing.start_tracing(sample=1.0)
    client = RPCClient()
    try:
        assert client.call(server.endpoint, "echo", 3) == 3
        cs = [s for s in t_port.spans() if s.name == "rpc.client:echo"][-1]
        ss = [s for s in t_jax.spans() if s.name == "rpc.server:echo"][-1]
        assert ss.trace_id == cs.trace_id and ss.parent_id == cs.span_id
    finally:
        client.close()
        server.stop()
        tracing.stop_tracing()
        jax_tracing.stop_tracing()
