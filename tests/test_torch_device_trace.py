"""The port's device-trace session against the JAX package's.

- ``annotation_name``/``parse_annotation`` and ``_union_us`` equal to
  the JAX package's, malformed names included (``_union_us`` by
  hypothesis).
- A hand-built torch.profiler trace of the card — a kernel launch, a
  CUDA-graph replay, a memcpy and a memset, each joined through its
  ``correlation`` id to the launch and then to the innermost annotation
  on the launching thread — parsed by a session never started (as the
  JAX package's parses its logdir): the expected join, kernel names
  from the kernels' functions (``_build.KERNEL_SYMBOLS``),
  ``kernel_seconds`` and a ``step_breakdown`` that sums exactly.
- ``merged_chrome_trace`` equal to the JAX package's on the same
  annotation, slice and joined lists.
- The disabled and unsampled paths emit no annotation.
- A CPU session around a CPU Predictor request joins its ops under the
  request's trace id (the JAX package's
  ``test_device_trace_session_joins_host_span`` and
  ``test_kernel_entry_annotations_unsampled_and_off_paths``, rerun over
  the port: both fail in the JAX suite on the installed JAX).
"""

from __future__ import annotations

import copy
import glob
import json
import os
import re
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu.observability import device_trace as jax_device_trace
import torch_port_helpers  # noqa: F401  (caps torch's threads)
from torch_port_helpers import fresh_port_programs

import paddle_tpu_torch as pt
from paddle_tpu_torch import _build
from paddle_tpu_torch.core.types import NoCUDADeviceError
from paddle_tpu_torch.models.transformer import transformer_encoder_model
from paddle_tpu_torch.observability import device_trace, metrics, tracing
from paddle_tpu_torch.ops import epilogue

LM = dict(vocab_size=64, max_len=8, d_model=16, n_head=2, d_inner=32,
          n_layer=1, dropout_rate=0.0, is_test=True)
# the JAX package's annotation sites (flash_attention, flash_decode,
# paged_kv_append, fc_epilogue, conv2d_epilogue, conv2d_bn_act)
JAX_SITES = {"flash_attention", "flash_decode", "paged_kv_append",
             "fc_epilogue", "conv2d_epilogue", "conv2d_bn_act"}


@pytest.fixture
def tracer():
    t = tracing.start_tracing()
    t.clear()
    t.sample_rate = 1.0
    try:
        yield t
    finally:
        tracing.stop_tracing()


# ---------------------------------------------------------------------------
# the grammar and the interval union
# ---------------------------------------------------------------------------

NAMES = ["pt#flash_attention#abc", "pt#executor.step#-", "pt#k#",
         "pt##abc", "pt#", "pt#a#b#c", "pt#a", "xx#a#b", "", None,
         "pt#conv2d_bn_act#0123456789abcdef", "PT#a#b", "pt#a b#c d"]


@pytest.mark.parametrize("name", NAMES)
def test_parse_annotation_matches_jax(name):
    assert device_trace.parse_annotation(name) == \
        jax_device_trace.parse_annotation(name)


@pytest.mark.parametrize("kernel, trace_id", [
    ("flash_attention", "abc"), ("executor.step", None),
    ("fc_epilogue", ""), ("a#b", "c")])
def test_annotation_name_matches_jax_and_round_trips(kernel, trace_id):
    name = device_trace.annotation_name(kernel, trace_id)
    assert name == jax_device_trace.annotation_name(kernel, trace_id)
    assert ":" not in name
    parsed = device_trace.parse_annotation(name)
    if "#" not in kernel:
        assert parsed == (kernel, trace_id or None)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.integers(-1000, 1000),
                          st.integers(0, 500)), max_size=30))
def test_union_us_matches_jax(pairs):
    intervals = [(float(s), float(s + d)) for s, d in pairs]
    got = device_trace._union_us(intervals)
    assert got == jax_device_trace._union_us(intervals)
    assert 0.0 <= got <= sum(e - s for s, e in intervals)


# ---------------------------------------------------------------------------
# a hand-built trace of the card
# ---------------------------------------------------------------------------

HOST, T0, T1, STREAM = 4242, 11, 12, 7


def _x(cat, name, ts, dur, pid, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _card_trace():
    """Two requests on thread T0 (a replay, then an interpreted step),
    and a launch on thread T1 under no annotation."""
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": HOST, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "CUDA GPU 0"}},
        # request A: a CUDA-graph replay, then the logits' copy out
        _x("user_annotation", "pt#executor.step#aaa", 100.0, 50.0, HOST,
           T0),
        _x("cuda_runtime", "cudaGraphLaunch", 110.0, 5.0, HOST, T0,
           correlation=5),
        _x("kernel", "void (anonymous namespace)::flash_fwd_f32_kernel"
           "<64>(Params)", 160.0, 20.0, 0, STREAM, correlation=5),
        _x("kernel", "volta_sgemm_128x64_nn", 181.0, 9.0, 0, STREAM,
           correlation=5),
        _x("cuda_runtime", "cudaMemcpyAsync", 140.0, 2.0, HOST, T0,
           correlation=6),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 190.0, 10.0,
           0, STREAM, correlation=6),
        # the profiler's device-side copy of an annotation: not one
        _x("gpu_user_annotation", "pt#executor.step#aaa", 160.0, 40.0, 0,
           STREAM),
        # request B: an interpreted step, an fc_epilogue and a conv under
        # their entry annotations, a memset, a conv under the step
        _x("user_annotation", "pt#executor.step#bbb", 300.0, 100.0, HOST,
           T0),
        _x("user_annotation", "pt#fc_epilogue#bbb", 310.0, 20.0, HOST, T0),
        _x("cuda_runtime", "cudaLaunchKernel", 315.0, 3.0, HOST, T0,
           correlation=7),
        _x("kernel", "_ZN12_GLOBAL__N_115fc_wgmma_kernelEv", 320.0, 30.0,
           0, STREAM, correlation=7),
        _x("cuda_runtime", "cudaLaunchKernel", 325.0, 1.0, HOST, T0,
           correlation=8),
        _x("kernel", "elementwise_kernel", 351.0, 4.0, 0, STREAM,
           correlation=8),
        _x("user_annotation", "pt#conv2d_bn_act#bbb", 335.0, 10.0, HOST,
           T0),
        _x("cuda_driver", "cuLaunchKernel", 336.0, 1.0, HOST, T0,
           correlation=9),
        _x("kernel", "conv_wgmma_kernel<128, false>", 356.0, 14.0, 0,
           STREAM, correlation=9),
        _x("cuda_runtime", "cudaLaunchKernel", 360.0, 1.0, HOST, T0,
           correlation=10),
        _x("kernel", "conv_f32_kernel", 371.0, 4.0, 0, STREAM,
           correlation=10),
        _x("cuda_runtime", "cudaMemsetAsync", 362.0, 1.0, HOST, T0,
           correlation=11),
        _x("gpu_memset", "Memset (Device)", 376.0, 2.0, 0, STREAM,
           correlation=11),
        # another thread's launch, under no annotation; a kernel whose
        # launch the trace lost
        _x("cuda_runtime", "cudaLaunchKernel", 120.0, 1.0, HOST, T1,
           correlation=12),
        _x("kernel", "bn_apply_tiled_kernel<float>", 400.0, 5.0, 0,
           STREAM + 1, correlation=12),
        _x("kernel", "flash_decode_kernel<1>", 410.0, 5.0, 0, STREAM,
           correlation=99),
        _x("cpu_op", "aten::mm", 312.0, 2.0, HOST, T0),
    ]}


def _parsed(tmp_path, trace=None):
    """A session never started: it parses the newest trace in logdir."""
    logdir = str(tmp_path)
    with open(os.path.join(logdir, "device_trace.hand.json"), "w") as f:
        json.dump(trace or _card_trace(), f)
    return device_trace.DeviceTraceSession(
        logdir, registry=metrics.MetricsRegistry()).stop()


def test_hand_built_card_trace_joins_by_correlation(tmp_path):
    sess = _parsed(tmp_path)
    assert [(a["kernel"], a["trace_id"]) for a in sess.annotations] == [
        ("executor.step", "aaa"), ("executor.step", "bbb"),
        ("fc_epilogue", "bbb"), ("conv2d_bn_act", "bbb")]
    assert len(sess.device_slices) == 10      # no cpu_op on the card
    joined = {j["name"]: (j["kernel"], j["trace_id"]) for j in sess.joined}
    assert joined == {
        # a replayed port kernel takes its name from its function
        "void (anonymous namespace)::flash_fwd_f32_kernel<64>(Params)":
            ("flash_attention", "aaa"),
        "volta_sgemm_128x64_nn": ("executor.step", "aaa"),
        "Memcpy DtoH (Device -> Pinned)": ("executor.step", "aaa"),
        "_ZN12_GLOBAL__N_115fc_wgmma_kernelEv": ("fc_epilogue", "bbb"),
        "elementwise_kernel": ("fc_epilogue", "bbb"),
        # the conv kernel keeps the annotation that launched it...
        "conv_wgmma_kernel<128, false>": ("conv2d_bn_act", "bbb"),
        # ...and takes its default name under the step alone
        "conv_f32_kernel": ("conv2d_epilogue", "bbb"),
        "Memset (Device)": ("executor.step", "bbb"),
    }
    transfer = {j["name"] for j in sess.joined if j["transfer"]}
    assert transfer == {"Memcpy DtoH (Device -> Pinned)", "Memset (Device)"}
    ks = sess.kernel_seconds()
    assert ks == pytest.approx({
        "flash_attention": 20e-6, "executor.step": 21e-6,
        "fc_epilogue": 34e-6, "conv2d_bn_act": 14e-6,
        "conv2d_epilogue": 4e-6})


def test_hand_built_step_breakdown_sums_exactly(tmp_path):
    sess = _parsed(tmp_path)
    ns = sess.step_breakdown_ns()
    # step A: [100, 200] (its last slice, the copy, ends at 200), busy
    # 160-180 and 181-190, the copy 190-200; step B: [300, 400] (its
    # annotation outlasts its slices), busy 320-350, 351-355, 356-370,
    # 371-375, the memset 376-378
    assert ns == {"total": 200_000, "compute": 29_000 + 52_000,
                  "transfer": 10_000 + 2_000,
                  "host_gap": 200_000 - 81_000 - 12_000}
    assert ns["compute"] + ns["transfer"] + ns["host_gap"] == ns["total"]
    bd = sess.step_breakdown()
    assert bd == {k: v / 1e9 for k, v in ns.items()}
    reg = sess._registry
    assert reg.get("paddle_tpu_device_step_seconds_total").value(
        component="transfer") == pytest.approx(12e-6)
    slices = reg.get("paddle_tpu_device_trace_slices_total")
    assert (slices.value(kind="annotation"), slices.value(kind="device"),
            slices.value(kind="joined")) == (4, 10, 8)


def test_step_window_extends_to_its_last_slice(tmp_path):
    """A step's kernels run after its range closed: the window reaches
    the last of them, so compute never exceeds total."""
    trace = {"traceEvents": [
        _x("user_annotation", "pt#executor.step#t", 0.0, 10.0, HOST, T0),
        _x("cuda_runtime", "cudaGraphLaunch", 5.0, 1.0, HOST, T0,
           correlation=1),
        _x("kernel", "flash_fwd_bf16_kernel<64>", 20.0, 100.0, 0, STREAM,
           correlation=1)]}
    bd = _parsed(tmp_path, trace).step_breakdown_ns()
    assert bd == {"total": 120_000, "compute": 100_000, "transfer": 0,
                  "host_gap": 20_000}


def test_merged_chrome_trace_matches_jax_on_the_same_lists(tmp_path):
    sess = _parsed(tmp_path)
    jsess = jax_device_trace.DeviceTraceSession(str(tmp_path / "jax"))
    for attr in ("annotations", "device_slices", "joined", "_meta"):
        setattr(jsess, attr, copy.deepcopy(getattr(sess, attr)))
    merged = sess.merged_chrome_trace()
    assert merged == jsess.merged_chrome_trace()
    dev = [e for e in merged["traceEvents"] if e["ph"] == "X" and e[
        "pid"] >= device_trace.DeviceTraceSession._PID_OFFSET and e[
        "args"].get("kernel") == "flash_attention"]
    assert [e["args"]["trace_id"] for e in dev] == ["aaa"]
    labels = {e["args"]["name"] for e in merged["traceEvents"]
              if e["ph"] == "M"}
    assert labels == {"device_annotations", "device:CUDA GPU 0"}


def test_kernel_symbols_cover_every_csrc_kernel():
    """Every __global__ function under csrc/ is in the map, under its
    source, and names only the JAX package's annotation sites."""
    found = {}
    for path in sorted(glob.glob(str(_build.CSRC_DIR / "*.cu"))):
        src = open(path).read()
        found[os.path.basename(path)[:-3]] = set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(\w+)\s*\(", src))
    assert {k: set(v[0]) for k, v in _build.KERNEL_SYMBOLS.items()} == \
        found
    names = {n for _, ns in _build.KERNEL_SYMBOLS.values() for n in ns}
    assert names <= JAX_SITES
    # no kernel function is a substring of another (a name finds one)
    syms = [s for v in _build.KERNEL_SYMBOLS.values() for s in v[0]]
    assert not [(a, b) for a in syms for b in syms if a != b and a in b]
    for sym, want in device_trace._SYMBOLS:
        assert device_trace.kernel_of_function(
            "void (anonymous namespace)::%s<1>(Params)" % sym) == want


# ---------------------------------------------------------------------------
# the sites: off, unsampled, and a CPU session
# ---------------------------------------------------------------------------

def _fc_args():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 8).astype(np.float32))
    w = torch.from_numpy(rng.rand(8, 3).astype(np.float32))
    return x, w


def _annotations_of(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("pt#")]


def test_kernel_entry_annotations_unsampled_and_off_paths():
    """Kernel entries run unchanged with tracing off and emit nothing; an
    UNSAMPLED trace emits no annotation; a sampled one names the kernel
    and its trace id, and a site outside any trace says ``-``."""
    x, w = _fc_args()
    want = epilogue.fc_epilogue(x, w, act="relu")
    assert tracing._tracer is None
    assert device_trace.annotate("fc_epilogue") is device_trace._NULL
    assert _annotations_of(
        lambda: epilogue.fc_epilogue(x, w, act="relu")) == []
    t = tracing.start_tracing(sample=0.5)
    try:
        ids = {}
        for i in range(64):
            with t.span("r%d" % i) as sp:
                got = epilogue.fc_epilogue(x, w, act="relu")
                assert torch.equal(got, want)
                ids[sp.trace_id] = _annotations_of(
                    lambda: epilogue.fc_epilogue(x, w, act="relu"))
        sampled = {tid for tid in ids if tracing.sampled(tid)}
        assert 0 < len(sampled) < len(ids)
        for tid, names in ids.items():
            assert names == (["pt#fc_epilogue#" + tid]
                             if tid in sampled else []), tid
        assert _annotations_of(
            lambda: epilogue.fc_epilogue(x, w)) == ["pt#fc_epilogue#-"]
    finally:
        tracing.stop_tracing()
    t = tracing.start_tracing(sample=0.0)     # installs nothing
    try:
        assert tracing._tracer is None
    finally:
        tracing.stop_tracing()


def _lm_predictor(tmp_path):
    with fresh_port_programs():
        model = transformer_encoder_model(**LM)
        exe = pt.Executor(pt.CPUPlace())
        np.random.seed(0)
        exe.run(pt.default_startup_program())
        d = str(tmp_path / "lm")
        pt.io.save_inference_model(d, ["src_ids"], [model["logits"]], exe)
    cfg = pt.inference.Config(d)
    cfg.disable_gpu()
    return pt.inference.create_predictor(cfg)


def test_cpu_session_joins_a_predictor_request_under_its_trace_id(
        tracer, tmp_path):
    """The port's counterpart of the JAX package's
    test_device_trace_session_joins_host_span: the request's
    executor.step and flash_attention annotations carry its trace id,
    the top-level ops under them join it, per-kernel seconds and the
    step breakdown land in the registry, and the merged chrome trace
    carries the id on a device lane."""
    pred = _lm_predictor(tmp_path)
    ids = np.random.RandomState(1).randint(0, LM["vocab_size"],
                                           (2, LM["max_len"], 1))
    want, = pred.run([ids])                  # the capture of the key
    reg = metrics.registry()
    k0 = reg.get("paddle_tpu_device_kernel_seconds_total")
    k0 = k0.total() if k0 else 0.0
    sess = device_trace.DeviceTraceSession(str(tmp_path / "devtrace"),
                                           device="cpu").start()
    with tracer.span("request") as root:
        for _ in range(2):
            got, = pred.run([ids])
    sess.stop()
    assert np.array_equal(got, want)
    assert os.path.dirname(sess.trace_path) == str(tmp_path / "devtrace")
    kinds = [(a["kernel"], a["trace_id"]) for a in sess.annotations]
    assert kinds.count(("executor.step", root.trace_id)) == 2
    assert kinds.count(("flash_attention", root.trace_id)) == 2
    joined = [j for j in sess.joined if j["trace_id"] == root.trace_id]
    assert joined and len(joined) == len(sess.joined)
    ksec = sess.kernel_seconds()
    assert ksec["executor.step"] > 0.0 and ksec["flash_attention"] > 0.0
    ns = sess.step_breakdown_ns()
    assert ns["total"] > 0 and ns["compute"] > 0
    assert ns["compute"] + ns["transfer"] + ns["host_gap"] == ns["total"]
    assert reg.get("paddle_tpu_device_kernel_seconds_total").total() > k0
    assert reg.get("paddle_tpu_device_step_seconds_total").value(
        component="compute") > 0.0
    p = str(tmp_path / "merged.json")
    sess.export_merged(p, tracer=tracer)
    with open(p) as f:
        doc = json.load(f)
    host = [e for e in doc["traceEvents"] if e.get("name") == "request"]
    assert host and host[0]["args"]["trace_id"] == root.trace_id
    dev = [e for e in doc["traceEvents"]
           if e.get("pid", 0) >= device_trace.DeviceTraceSession._PID_OFFSET
           and e.get("args", {}).get("trace_id") == root.trace_id
           and e.get("ph") == "X"]
    assert dev


def test_session_asks_for_the_card_unless_told_the_cpu(tmp_path):
    sess = device_trace.DeviceTraceSession(str(tmp_path))
    assert sess.device.type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the session records it")
    with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
        sess.start()
    with pytest.raises(ValueError):
        device_trace.DeviceTraceSession(str(tmp_path), device="meta")


def test_session_refuses_to_start_beside_another_capture(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(device_trace.CaptureRunningError):
            device_trace.DeviceTraceSession(str(tmp_path),
                                            device="cpu").start()
    with device_trace.DeviceTraceSession(str(tmp_path), device="cpu"):
        pass


def test_session_records_a_servers_worker_threads(tracer, tmp_path):
    """The replicas run requests on their own threads: a session joins
    their ops under the request's trace id (the serving.submit root)."""
    from paddle_tpu_torch import serving

    pred = _lm_predictor(tmp_path)
    ids = np.random.RandomState(2).randint(0, LM["vocab_size"],
                                           (1, LM["max_len"], 1))
    with serving.InferenceServer(
            lambda i: pred, serving.ServingConfig(n_replicas=1,
                                                  max_batch=1)) as srv:
        srv.infer({"src_ids": ids}, timeout=60)      # the capture
        sess = device_trace.DeviceTraceSession(
            str(tmp_path / "srv"), device="cpu").start()
        req = srv.submit({"src_ids": ids})
        req.result(timeout=60)
        sess.stop()
    roots = [s for s in tracer.spans() if s.name == "serving.submit"]
    tid = roots[-1].trace_id
    steps = [a for a in sess.annotations if a["kernel"] == "executor.step"]
    assert [a["trace_id"] for a in steps] == [tid]
    assert steps[0]["tid"] != threading.get_native_id()   # a replica's
    joined = [j for j in sess.joined if j["trace_id"] == tid]
    assert {j["kernel"] for j in joined} == {"executor.step",
                                             "flash_attention"}
