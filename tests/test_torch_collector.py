"""The port's fleet collector (paddle_tpu_torch/observability/
collector.py) against the JAX package's.

The contracts of tests/test_fleet_observability.py's collector cases
rerun over the port: fleet series and the process bound, exactly-once
ingest under a seeded push-loss plan with staleness, cross-process trace
assembly, the varz poll, the fleet SLO roll-up, no pusher and no new
wire bytes when off, the env knob reaching both server configs, and the
trainer's step-boundary push on the interpreted and the compiled path.
Then the two packages on one wire: a port pusher into a JAX
CollectorServer and a JAX pusher into the port's, and a port pserver's
varz polled by the port's collector.
"""

import time

import numpy as np
import pytest
from torch_port_helpers import fresh_port_programs

import paddle_tpu_torch as pt
from paddle_tpu.observability import collector as jax_collector
from paddle_tpu.observability import tracing as jax_tracing
from paddle_tpu_torch import serving
from paddle_tpu_torch.distributed import faultinject
from paddle_tpu_torch.distributed.faultinject import FaultPlan
from paddle_tpu_torch.distributed.rpc import RPCClient, RPCServer
from paddle_tpu_torch.observability import collector as obs_collector
from paddle_tpu_torch.observability import tracing


@pytest.fixture
def collector_server():
    c = obs_collector.CollectorServer("127.0.0.1:0")
    c.start()
    try:
        yield c
    finally:
        c.stop()


def _push(client, endpoint, process, seq, spans=(), metrics_snap=None,
          slo_evals=None, dumps=(), role="test"):
    return client.call(endpoint, obs_collector.MSG_PUSH, {
        "process": process, "role": role, "seq": seq,
        "spans": list(spans), "metrics": metrics_snap,
        "slo": slo_evals, "dumps": list(dumps), "ts": time.time()},
        retries=0)


def _span(tid, sid, parent=None, name="s", t0=0.0, t1=1.0):
    return {"name": name, "trace_id": tid, "span_id": sid,
            "parent_id": parent, "t0_us": t0, "t1_us": t1, "attrs": {}}


def _save_model(tmp_path, in_dim=8):
    d = str(tmp_path / "fc")
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[in_dim], dtype="float32")
        pred = pt.layers.fc(x, size=2)
        exe = pt.Executor(pt.CPUPlace())
        exe.run(pt.default_startup_program())
        pt.io.save_inference_model(d, ["x"], [pred], exe)
    return d


def _predictor(d):
    cfg = pt.inference.Config(d)
    cfg.disable_gpu()
    return pt.inference.create_predictor(cfg)


def test_collector_fleet_series_and_process_bound(collector_server):
    c = collector_server
    client = RPCClient()
    try:
        snap = {"m_total": {"type": "counter",
                            "series": [{"labels": {"k": "v"},
                                        "value": 2.0}]}}
        _push(client, c.endpoint, "p1", 1, metrics_snap=snap,
              role="serving")
        _push(client, c.endpoint, "p2", 1, metrics_snap=snap,
              role="pserver")
        series = c.fleet_metrics()["m_total"]["series"]
        assert {(s["labels"]["process"], s["labels"]["role"])
                for s in series} == {("p1", "serving"), ("p2", "pserver")}
        assert all(s["labels"]["k"] == "v" for s in series)
        small = obs_collector.CollectorServer(
            "127.0.0.1:0", max_processes=2).start()
        try:
            for i in range(6):
                _push(client, small.endpoint, "proc%d" % i, 1)
            procs = small.snapshot()["processes"]
            assert len(procs) == 3 and "overflow" in procs
        finally:
            small.stop()
    finally:
        client.close()


def test_collector_push_loss_exactly_once_and_stale(tmp_path):
    """A seeded plan drops (ingested, reply lost) then closes (never
    ingested) the pushes: the frozen-seq retry and the collector's seq
    dedup land the span batch and the dump reference exactly once; a
    silent process reads as stale."""
    from paddle_tpu_torch.observability import flight_recorder

    c = obs_collector.CollectorServer("127.0.0.1:0",
                                      stale_after=0.3).start()
    tracing.stop_tracing()
    t = tracing.start_tracing(sample=1.0)
    dump = tmp_path / "flight_1_1_test.json"
    dump.write_text("{}")
    try:
        with t.span("only-trace"):
            pass
        plan = FaultPlan().on(obs_collector.MSG_PUSH, 0, "drop") \
                          .on(obs_collector.MSG_PUSH, 1, "close")
        with faultinject.installed(plan) as inj:
            p = obs_collector.CollectorPusher(
                c.endpoint, role="t", process="victim", interval_s=30.0,
                deadline=2.0)
            p.start()
            flight_recorder.recorder()._dump_paths.append(str(dump))
            assert not p.push_now()     # drop: landed, reply lost
            assert not p.push_now()     # close: never arrived
            assert p.push_now()         # same seq -> deduped ack
            assert p.push_now()         # next seq: no further spans
            assert len(inj.log) == 2
        snap = c.snapshot()
        victim = snap["processes"]["victim"]
        assert victim["span_count"] == 1
        assert [d["path"] for d in snap["dumps"]].count(str(dump)) == 1
        assert p.pushes_failed == 2 and p.pushes_ok == 2
        tid = c.trace_ids()[0]
        assert len(c.trace(tid)) == 1
        assert not victim["stale"]
        time.sleep(0.4)
        assert c.snapshot()["processes"]["victim"]["stale"]
        p.stop(final_push=False)
    finally:
        flight_recorder.recorder()._dump_paths.remove(str(dump))
        tracing.stop_tracing()
        c.stop()


def test_collector_trace_assembly_and_completeness(collector_server):
    c = collector_server
    client = RPCClient()
    tid = "deadbeef00000001"
    try:
        _push(client, c.endpoint, "client-proc", 1,
              spans=[_span(tid, "1", None, "rpc.client:echo")])
        assert c.trace_complete(tid) and len(c.trace(tid)) == 1
        _push(client, c.endpoint, "server-proc", 1,
              spans=[_span(tid, "s1", "1", "rpc.server:echo")])
        spans = c.trace(tid)
        assert {s["process"] for s in spans} == {"client-proc",
                                                 "server-proc"}
        assert c.trace_complete(tid)
        _push(client, c.endpoint, "server-proc", 2,
              spans=[_span(tid, "s2", "missing", "child")])
        assert not c.trace_complete(tid)
    finally:
        client.close()


def test_collector_varz_poll(collector_server):
    c = collector_server
    srv = RPCServer("127.0.0.1:0").start()
    srv.register_handler(
        "varz", lambda _=None: {"m_total": {
            "type": "counter", "series": [{"labels": {}, "value": 1.0}]}})
    try:
        name = c.poll_varz(srv.endpoint)
        assert name == "pserver@" + srv.endpoint
        assert c.snapshot()["processes"][name]["role"] == "pserver"
        assert "m_total" in c.fleet_metrics()
        assert c.poll_varz("127.0.0.1:1", deadline=0.3) is None
    finally:
        srv.stop()


def test_fleet_slo_rollup(collector_server):
    c = collector_server
    client = RPCClient()
    try:
        _push(client, c.endpoint, "a", 1, slo_evals={
            "serving_availability": {
                "objective": 0.99, "good": 90.0, "total": 100.0,
                "burn_rate_slow": 10.0, "firing": True}})
        _push(client, c.endpoint, "b", 1, slo_evals={
            "serving_availability": {
                "objective": 0.99, "good": 300.0, "total": 300.0,
                "burn_rate_slow": 0.0, "firing": False}})
        fleet = c.fleet_slo()["serving_availability"]
        assert fleet["attained"] == pytest.approx(390.0 / 400.0)
        assert fleet["burn_rate"] == pytest.approx(1000.0 / 400.0)
        assert fleet["firing"] is True and fleet["processes"] == 2
    finally:
        client.close()


def test_wire_identity_collector_off_sample_zero(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_COLLECTOR", raising=False)
    assert tracing.start_tracing(sample=0.0) is None
    assert obs_collector.maybe_collector() is None
    seen = []
    srv = RPCServer("127.0.0.1:0").start()
    srv.register_handler("probe", lambda p: seen.append(p) or "ok")
    client = RPCClient()
    try:
        client.call(srv.endpoint, "probe", ("a", 1), retries=0)
    finally:
        client.close()
        srv.stop()
    assert seen == [("a", 1)]
    assert serving.ServingConfig().collector is None
    d = _save_model(tmp_path)
    isrv = serving.InferenceServer(
        lambda i: _predictor(d), serving.ServingConfig(n_replicas=1)).start()
    try:
        assert isrv.collector_pusher is None
    finally:
        isrv.stop()


def test_collector_env_knob_reaches_configs(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_COLLECTOR", "127.0.0.1:9")
    assert serving.ServingConfig().collector == "127.0.0.1:9"
    assert serving.DecodeConfig(device="cpu").collector == "127.0.0.1:9"
    monkeypatch.delenv("PADDLE_TPU_COLLECTOR")
    assert serving.ServingConfig().collector is None
    assert serving.DecodeConfig(device="cpu").collector is None


@pytest.mark.parametrize("compiled", [False, True])
def test_trainer_step_boundary_push(collector_server, monkeypatch,
                                    compiled):
    """Both step paths push through the env-derived pusher: trainers
    join the fleet with no code change."""
    monkeypatch.setenv("PADDLE_TPU_COLLECTOR", collector_server.endpoint)
    monkeypatch.setenv("PADDLE_TPU_COLLECTOR_PUSH_INTERVAL", "0.01")
    obs_collector.reset_env_pusher()
    try:
        with fresh_port_programs():
            x = pt.layers.data("x", shape=[4], dtype="float32")
            pred = pt.layers.fc(x, size=1)
            exe = pt.Executor(pt.CPUPlace())
            exe.run(pt.default_startup_program())
            prog = pt.default_main_program()
            if compiled:
                prog = pt.CompiledProgram(prog)
            feed = {"x": np.zeros((2, 4), np.float32)}
            deadline = time.monotonic() + 10.0
            found = False
            while time.monotonic() < deadline and not found:
                exe.run(prog, feed=feed, fetch_list=[pred])
                found = any(p["role"] == "trainer" for p in
                            collector_server.snapshot()["processes"]
                            .values())
                time.sleep(0.02)
        assert found, collector_server.snapshot()["processes"]
    finally:
        obs_collector.reset_env_pusher()


def test_servers_push_to_the_collector(tmp_path):
    """ServingConfig(collector=...) and DecodeConfig(collector=...) each
    run a pusher from start() to stop(); stop() pushes once more."""
    c = obs_collector.CollectorServer("127.0.0.1:0").start()
    try:
        d = _save_model(tmp_path)
        isrv = serving.InferenceServer(
            lambda i: _predictor(d),
            serving.ServingConfig(n_replicas=1, collector=c.endpoint)
        ).start()
        isrv.submit({"x": np.ones((1, 8), np.float32)}).result(timeout=30)
        assert isrv.collector_pusher is not None
        isrv.stop()
        assert isrv.collector_pusher is None
        dsrv = serving.DecodeServer(config=serving.DecodeConfig(
            device="cpu", max_batch=2, collector=c.endpoint)).start()
        dsrv.submit(np.arange(2, 12)).result(timeout=60)
        dsrv.stop()
        roles = {p["role"] for p in c.snapshot()["processes"].values()}
        assert {"serving", "decode"} <= roles
    finally:
        c.stop()


# ---------------------------------------------------------------------------
# the two packages on one wire
# ---------------------------------------------------------------------------

def test_port_pusher_into_a_jax_collector():
    from paddle_tpu_torch.observability import metrics

    c = jax_collector.CollectorServer("127.0.0.1:0").start()
    t = tracing.start_tracing(sample=1.0)
    metrics.counter("paddle_tpu_test_port_pushes_total",
                    "a series only the port's registry has").inc(3)
    try:
        with t.span("port-root"):
            with t.span("port-child"):
                pass
        p = obs_collector.CollectorPusher(c.endpoint, role="trainer",
                                          process="port", interval_s=30)
        p.start()
        assert p.push_now()
        p.stop(final_push=False)
        snap = c.snapshot()
        assert snap["processes"]["port"]["span_count"] == 2
        assert snap["processes"]["port"]["role"] == "trainer"
        tid = [s for s in t.spans() if s.name == "port-root"][0].trace_id
        assert c.trace_complete(tid)
        series = c.fleet_metrics()["paddle_tpu_test_port_pushes_total"]
        assert [(s["labels"]["process"], s["value"])
                for s in series["series"]] == [("port", 3.0)]
    finally:
        tracing.stop_tracing()
        c.stop()


def test_jax_pusher_into_the_port_collector():
    c = obs_collector.CollectorServer("127.0.0.1:0").start()
    t = jax_tracing.start_tracing(sample=1.0)
    try:
        with t.span("jax-root"):
            pass
        p = jax_collector.CollectorPusher(c.endpoint, role="serving",
                                          process="jax", interval_s=30)
        p.start()
        assert p.push_now()
        p.stop(final_push=False)
        snap = c.snapshot()
        assert snap["processes"]["jax"]["span_count"] == 1
        tid = [s for s in t.spans() if s.name == "jax-root"][0].trace_id
        assert c.trace_complete(tid)
    finally:
        jax_tracing.stop_tracing()
        c.stop()


def test_collector_polls_a_port_pservers_varz():
    """A port pserver (listen_and_serv on a thread) answers the varz
    poll with its registry snapshot; /fleetz lists it."""
    import json
    import threading
    import urllib.request

    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.distributed.rpc import global_rpc_client
    from paddle_tpu_torch.transpiler.details import wait_server_ready

    c = obs_collector.CollectorServer("127.0.0.1:0", http_port=0).start()
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        loss = pt.layers.mean(pt.layers.fc(x, size=1))
        pt.optimizer.SGD(0.1).minimize(loss)
        srv = RPCServer("127.0.0.1:0")
        ep = srv.endpoint
        srv.stop()
        t = pt.transpiler.DistributeTranspiler()
        t.transpile(0, pservers=ep, trainers=1)
        main, startup = t.get_pserver_programs(ep)
        exe, scope = pt.Executor(pt.CPUPlace()), Scope()
        exe.run(startup, scope=scope)
        th = threading.Thread(target=exe.run, args=(main,),
                              kwargs={"scope": scope}, daemon=True)
        th.start()
        try:
            wait_server_ready([ep], timeout=30)
            assert c.poll_varz(ep) == "pserver@" + ep
            doc = json.loads(urllib.request.urlopen(
                c.http_server.url + "/fleetz", timeout=10).read())
            assert doc["processes"]["pserver@" + ep]["role"] == "pserver"
            assert "paddle_tpu_rpc_server_requests_total" in doc["metrics"]
        finally:
            global_rpc_client().send_complete(ep, peer_id="trainer0")
            th.join(timeout=30)
            c.stop()
    assert not th.is_alive()
