"""The port's Fluid profiler and the executor's debug flags against the
JAX package's.

- The JAX tests rerun over ``paddle_tpu_torch``:
  ``test_profiler_shim_roundtrip_through_timeline``,
  ``test_profiler_spans_join_request_trace``,
  ``test_record_event_legacy_signature_without_profiler``
  (tests/test_observability.py), ``test_profiler_records_op_spans``,
  ``test_check_nan_inf_flag``, ``test_flags_env_and_types``
  (tests/test_profiler_debug.py), ``test_profiler_tracer_option_device_
  path`` and ``test_profiler_without_tracer_option_unchanged``
  (tests/test_perf_observability.py), the device path on the CPU
  (``state="CPU"``).
- The same program under ``profile_ops`` records the same op spans in
  both packages; ``check_nan_inf`` names the same output and op.
- The flags ``check_nan_inf``, ``benchmark`` and ``profile_ops`` have
  the JAX defaults and docs; remote profiling raises, naming ROADMAP
  Queue 1 item 5.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import layers as jax_layers
from paddle_tpu import profiler as jax_profiler
import torch_port_helpers  # noqa: F401  (caps torch's threads)
from torch_port_helpers import fresh_port_programs

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, profiler
from paddle_tpu_torch.core.program import Program as PortProgram
from paddle_tpu_torch.core.types import NoCUDADeviceError
from paddle_tpu_torch.observability import device_trace, metrics, tracing


def _tools_mod(name):
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tracer():
    t = tracing.start_tracing()
    t.clear()
    try:
        yield t
    finally:
        tracing.stop_tracing()


@pytest.fixture
def port_flags():
    """Restores the port's debug flags after the test."""
    saved = {k: flags.get_flag(k)
             for k in ("profile_ops", "check_nan_inf", "benchmark")}
    try:
        yield
    finally:
        flags.set_flags(saved)


def _small_net(L):
    x = L.data("x", shape=[4], dtype="float32")
    h = L.fc(x, size=4, act="relu")
    return x, L.mean(h)


def _port_small_net():
    """The JAX package's small net, run by the port from its bytes."""
    _, out = _small_net(jax_layers)
    return (PortProgram.parse_from_bytes(
        fluid.default_main_program().to_bytes()),
        PortProgram.parse_from_bytes(
            fluid.default_startup_program().to_bytes()), out.name)


# ---------------------------------------------------------------------------
# the profiler shim
# ---------------------------------------------------------------------------

def test_profiler_shim_roundtrip_through_timeline(tmp_path):
    tl = _tools_mod("timeline")
    paths = []
    for w in range(2):
        profiler.start_profiler()
        with profiler.RecordEvent("opA"):
            time.sleep(0.001)
        with profiler.RecordEvent("opB"):
            pass
        p = str(tmp_path / ("p%d.json" % w))
        profiler.stop_profiler(profile_path=p)
        paths.append(("trainer%d" % w, p))
        with open(p) as f:
            trace = json.load(f)
        names = [e["name"] for e in trace["traceEvents"]]
        assert names.count("opA") == 1 and names.count("opB") == 1
        ev = [e for e in trace["traceEvents"]
              if e["name"] == "opA"][0]
        assert ev["ph"] == "X" and ev["dur"] >= 1000   # >= 1ms in us
    merged = tl.merge_traces(paths)
    pids = {(e.get("name"), e["pid"])
            for e in merged["traceEvents"]}
    assert ("opA", 0) in pids and ("opA", 1) in pids
    assert ("process_name", 0) in pids and ("process_name", 1) in pids


def test_profiler_spans_join_request_trace(tracer):
    """With the tracing flag on, RecordEvent is a span site: op spans
    join the ACTIVE trace (the executor-inside-serving story)."""
    with tracer.span("request") as root:
        with profiler.RecordEvent("matmul"):
            pass
    spans = tracer.spans_for(root.trace_id)
    assert {"request", "matmul"} <= {s.name for s in spans}


def test_record_event_legacy_signature_without_profiler():
    """RecordEvent outside start/stop_profiler and with tracing off is
    a no-op (the executor's profile_ops guard calls it freely)."""
    assert profiler._prof_tracer is None and tracing._tracer is None
    with profiler.RecordEvent("anything"):
        pass
    profiler.reset_profiler()
    assert profiler._prof_tracer is None


def test_profiler_without_tracer_option_unchanged(tmp_path):
    """The legacy no-device path: no session, plain host chrome
    export, as in the JAX package."""
    profiler.start_profiler()
    with profiler.RecordEvent("opA"):
        pass
    p = str(tmp_path / "p.json")
    assert profiler.stop_profiler(profile_path=p) is None
    with open(p) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]]
    assert names.count("opA") == 1


def test_profiler_tracer_option_device_path(tmp_path):
    """start_profiler(tracer_option=...) opens the device session bound
    to the active span ctx (here on the host: state "CPU");
    stop_profiler routes through it, so the Fluid surface gets
    attribution, and the chrome export carries the device tracks."""
    reg = metrics.registry()
    k0 = reg.get("paddle_tpu_device_kernel_seconds_total")
    k0 = k0.value(kernel="profiler") if k0 else 0.0
    t = tracing.start_tracing()
    t.clear()
    try:
        with t.span("request") as root:
            profiler.start_profiler("CPU", tracer_option="Default")
            with profiler.RecordEvent("matmul"):
                a = torch.ones((128, 128))
                (a @ a).sum()
            p = str(tmp_path / "prof.json")
            sess = profiler.stop_profiler(profile_path=p)
    finally:
        tracing.stop_tracing()
    assert sess is not None and sess.device.type == "cpu"
    assert any(a["kernel"] == "profiler"
               and a["trace_id"] == root.trace_id
               for a in sess.annotations)
    joined = [j for j in sess.joined if j["trace_id"] == root.trace_id]
    assert joined, "no device slice joined the bound span ctx"
    k1 = reg.get("paddle_tpu_device_kernel_seconds_total").value(
        kernel="profiler")
    assert k1 > k0
    with open(p) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]}
    assert "matmul" in names             # host span survived the merge
    assert any(e.get("pid", 0) >= device_trace.DeviceTraceSession.
               _PID_OFFSET for e in doc["traceEvents"])


def test_profiler_device_path_asks_for_the_card(tmp_path):
    """Any state but "CPU" records the card: without one the device
    session raises, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the session records it")
    try:
        with pytest.raises(NoCUDADeviceError):
            profiler.start_profiler("All", tracer_option="Default")
    finally:
        profiler.stop_profiler()
    with pytest.raises(NoCUDADeviceError):
        with profiler.device_trace(str(tmp_path)):
            pass


def test_profiler_leaves_a_running_capture_alone(tmp_path):
    """A torch.profiler capture already running: the Fluid session
    keeps its host spans and opens no device half (the JAX package
    swallows any error of a second capture; the port this one only)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        profiler.start_profiler("CPU", tracer_option="Default")
        with profiler.RecordEvent("opA"):
            pass
        p = str(tmp_path / "p.json")
        assert profiler.stop_profiler(profile_path=p) is None
    with open(p) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]]
    assert names.count("opA") == 1


def test_device_trace_captures_into_logdir(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiler.device_trace(logdir, device="cpu"):
        torch.ones(8, 8).sum()
    (path,) = os.listdir(logdir)
    with open(os.path.join(logdir, path)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::sum" in names


def test_remote_profiler_raises_naming_its_item(tmp_path):
    """start_remote_profiler / stop_remote_profiler drive a pserver's
    ``profile`` handler, as in the JAX package: profiling switches on
    there, and the stop writes its chrome trace (here a CPU pserver's:
    its host ops, the SGD block's among them) and returns the path."""
    import threading

    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.distributed.rpc import (RPCServer,
                                                  global_rpc_client)

    with fresh_port_programs():
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = pt.layers.data("x", shape=[4], dtype="float32")
            loss = pt.layers.mean(pt.layers.fc(x, size=1))
            pt.optimizer.SGD(0.1).minimize(loss)
        srv = RPCServer("127.0.0.1:0")
        ep = srv.endpoint
        srv.stop()
        t = pt.transpiler.DistributeTranspiler()
        t.transpile(0, program=main, startup_program=startup, pservers=ep,
                    trainers=1)
        ps_main, ps_startup = t.get_pserver_programs(ep)
        exe = pt.Executor(pt.CPUPlace())
        ps_scope = Scope()
        exe.run(ps_startup, scope=ps_scope)
        th = threading.Thread(target=exe.run, args=(ps_main,),
                              kwargs={"scope": ps_scope}, daemon=True)
        th.start()
        try:
            pt.transpiler.wait_server_ready([ep], timeout=30)
            scope = Scope()
            exe.run(t.get_trainer_startup_program(), scope=scope)
            assert profiler.start_remote_profiler([ep]) == ["profiling"]
            exe.run(t.get_trainer_program(wait_port=False),
                    feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[loss], scope=scope)
            path = str(tmp_path / "ps_trace.json")
            assert profiler.stop_remote_profiler([ep], path) == [path]
        finally:
            global_rpc_client().send_complete(ep, peer_id="trainer0")
            th.join(timeout=30)
    assert not th.is_alive()
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert any(n.startswith("aten::") for n in names)


# ---------------------------------------------------------------------------
# the executor's debug flags
# ---------------------------------------------------------------------------

def test_profiler_records_op_spans(tmp_path, port_flags):
    """profile_ops: a RecordEvent span an interpreted op, in both
    packages alike (the same op types, in the same order)."""
    main, startup, out = _port_small_net()
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}
    flags.set_flags({"profile_ops": True})
    trace_path = str(tmp_path / "trace.json")
    with profiler.profiler(sorted_key="total", profile_path=trace_path):
        exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    with open(trace_path) as f:
        trace = json.load(f)
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert "mul" in names or "matmul" in names, names

    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(fluid.default_startup_program())
    fluid.set_flags({"profile_ops": True})
    jpath = str(tmp_path / "jax.json")
    try:
        with jax_profiler.profiler(sorted_key="total", profile_path=jpath):
            jexe.run(feed=feed, fetch_list=[out])
    finally:
        fluid.set_flags({"profile_ops": False})
    with open(jpath) as f:
        jnames = [e["name"] for e in json.load(f)["traceEvents"]
                  if e["ph"] == "X"]
    assert names == jnames


def test_profile_ops_off_records_no_op_span(tmp_path, port_flags):
    main, startup, out = _port_small_net()
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    flags.set_flags({"profile_ops": False})
    p = str(tmp_path / "t.json")
    with profiler.profiler(sorted_key=None, profile_path=p):
        exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[out], scope=scope)
    with open(p) as f:
        assert [e for e in json.load(f)["traceEvents"]
                if e["ph"] == "X"] == []


def test_check_nan_inf_flag(port_flags):
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[2], dtype="float32")
        out = pt.layers.mean(pt.layers.log(x))   # log(negative) -> NaN
        exe = pt.Executor(pt.CPUPlace())
        flags.set_flags({"check_nan_inf": True})
        with pytest.raises(FloatingPointError) as ei:
            exe.run(feed={"x": np.array([[-1.0, -2.0]], np.float32)},
                    fetch_list=[out])
        assert "log" in str(ei.value)
        flags.set_flags({"check_nan_inf": False})
        got, = exe.run(feed={"x": np.array([[-1.0, -2.0]], np.float32)},
                       fetch_list=[out])
        assert np.isnan(got).all()


def test_check_nan_inf_names_what_jax_names(port_flags):
    """The same program in both packages: the same output and op type
    are named, and a finite run passes."""
    x = jax_layers.data("x", shape=[2], dtype="float32")
    out = jax_layers.mean(jax_layers.log(x))
    main = PortProgram.parse_from_bytes(
        fluid.default_main_program().to_bytes())
    bad = {"x": np.array([[-1.0, 2.0]], np.float32)}
    fluid.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError) as je:
            fluid.Executor(fluid.CPUPlace()).run(feed=bad,
                                                 fetch_list=[out])
    finally:
        fluid.set_flags({"check_nan_inf": False})
    flags.set_flags({"check_nan_inf": True})
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(FloatingPointError) as pe:
        exe.run(main, feed=bad, fetch_list=[out.name], scope=pt.Scope())
    head = str(je.value).split(" (")[0]
    assert str(pe.value).split(" (")[0] == head
    ok, = exe.run(main, feed={"x": np.array([[1.0, 2.0]], np.float32)},
                  fetch_list=[out.name], scope=pt.Scope())
    assert np.isfinite(ok).all()


def test_flags_env_and_types(port_flags):
    names = ("check_nan_inf", "benchmark", "profile_ops")
    for name in names:
        assert flags.get_flag(name) is False
        assert flags._REGISTRY[name].help == jax_flags._REGISTRY[name].help
        assert flags._REGISTRY[name].type is bool
    flags.set_flags({"check_nan_inf": True})
    assert flags.get_flag("check_nan_inf") is True
    flags.set_flags({"check_nan_inf": "0"})
    assert flags.get_flag("check_nan_inf") is False
    with pytest.raises(KeyError):
        flags.set_flags({"no_such_flag": 1})
    assert set(names) <= set(flags.all_flags())
