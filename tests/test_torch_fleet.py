"""The model fleet of the port against the JAX package's: the registry,
the rolling rollout and its rollback, the SLO-actuated autoscaler, the
SLO engine that drives them and the IR verifier the registry calls.

- The contracts of tests/test_model_fleet.py (registry versioning,
  dedupe and typed errors, ``register_program``, rollout with zero drops
  under traffic, prewarm failure with no partial fleet, burn rollback to
  the exact fingerprint, rollback under a chaos plan, a replica added
  mid-rollout, scale-up after a rollout, the four autoscaler tests),
  manifest re-adoption and ``ManifestMismatchError`` (after
  tests/test_sharded_serving.py), and the SLO tests of
  tests/test_perf_observability.py, rerun over ``paddle_tpu_torch``.
- The SLO monitors of both packages, fed the same counts at the same
  times, give the same evaluations.
- The port's ``verify`` against the JAX ``verify`` on the same
  ``to_bytes`` programs: the LM's post-load IR is clean in both, and
  planted faults are named alike (rule, block, op, var, message).
- Two loads of one saved LM are one program in the port (one
  fingerprint, one ``to_dict``), so a rollout of that LM over two
  replicas converges; the same rollout through the JAX package rolls
  back with "stragglers" (two loads there differ in a pass's var name),
  asserted so that a change of the reference shows.

Models are built and saved by the JAX package (the fc net of
tests/test_model_fleet.py, a 1-layer d16 LM) and served by the port's
Predictors on the CPU: ``Config.disable_gpu()`` through the registry's
``configure``.  Outputs are held within rtol 1e-5, atol 1e-6 as in
tests/test_torch_serving_fleet.py; a swapped-in program serves its own
Predictor's bits.  The port's ``ir_verify`` is on in every test, as
conftest.py sets the JAX package's.  Every wait has a timeout.
"""

from __future__ import annotations

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.inference as jax_inference
from paddle_tpu import layers
from paddle_tpu import serving as jax_serving
from paddle_tpu.analysis import verify as jax_verify
from paddle_tpu.core.program import Program as JaxProgram
from paddle_tpu.models.transformer import \
    transformer_encoder_model as jax_lm
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.observability import slo as jax_slo
import torch_port_helpers  # noqa: F401  (caps torch's threads)
from torch_port_helpers import fresh_port_programs

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, inference, serving, unique_name
from paddle_tpu_torch.analysis import (VerifierError, verify,
                                       verify_enabled, verify_level,
                                       verify_roundtrip)
from paddle_tpu_torch.core.program import Program as PortProgram
from paddle_tpu_torch.distributed import faultinject
from paddle_tpu_torch.distributed.faultinject import FaultPlan
from paddle_tpu_torch.observability import flight_recorder, metrics, slo
from paddle_tpu_torch.serving import registry as port_registry
from paddle_tpu_torch.transpiler import FuseElewiseAddActTranspiler

RTOL, ATOL = 1e-5, 1e-6
LM = dict(vocab_size=64, max_len=8, d_model=16, n_head=2, d_inner=32,
          n_layer=1, dropout_rate=0.0, is_test=True)


@pytest.fixture(autouse=True)
def port_ir_verify_on():
    """The port's ir_verify on for each test (conftest.py does it for
    the JAX package's flag)."""
    flags.set_flags({"ir_verify": "on"})
    yield
    flags.set_flags({"ir_verify": "off"})


def _cpu(config):
    config.disable_gpu()


def _build_model(dirname, hidden=16, in_dim=8, seed=0):
    """Save the JAX package's tiny fc net (fresh programs each call);
    returns the model dir."""
    fluid.framework.switch_main_program(fluid.Program())
    fluid.framework.switch_startup_program(fluid.Program())
    x = layers.data("x", shape=[in_dim], dtype="float32")
    h = layers.fc(x, size=hidden, act="relu")
    pred = layers.fc(h, size=1)
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(seed)
    exe.run(fluid.default_startup_program())
    d = os.path.join(str(dirname), "model_h%d_s%d" % (hidden, seed))
    fluid.io.save_inference_model(d, ["x"], [pred], exe)
    return d


def _save_lm(dirname, d_inner=32, seed=0):
    """Save the JAX package's 1-layer d16 LM; returns the model dir."""
    fluid.framework.switch_main_program(fluid.Program())
    fluid.framework.switch_startup_program(fluid.Program())
    model = jax_lm(**dict(LM, d_inner=d_inner))
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(seed)
    exe.run(fluid.default_startup_program())
    d = os.path.join(str(dirname), "lm_i%d_s%d" % (d_inner, seed))
    fluid.io.save_inference_model(d, ["src_ids"], [model["logits"]], exe)
    return d


def _predictor(model_dir):
    cfg = inference.Config(model_dir)
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


def _factory(model_dir):
    return lambda i: _predictor(model_dir)


def _registry(root=None):
    return serving.ModelRegistry(root=root, configure=_cpu)


def _fps(srv):
    return {r.index: r.predictor.program_fingerprint()
            for r in srv.pool.replicas}


class _StubPredictor:
    """Predictor stand-in for pool-only tests (health probes never
    touch the predictor)."""

    def run(self, feeds):
        return feeds

    def feed_specs(self):
        return {}

    def get_input_names(self):
        return []


class _FireAfterFirstSwap:
    def __init__(self):
        self.polls = 0

    def observe(self):
        self.polls += 1
        return {}

    def firing(self):
        return ["serving_availability"] if self.polls >= 1 else []


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_versioning_dedupe_and_typed_errors(tmp_path):
    """Versions are monotonic per name, deduped by program fingerprint
    (the same dir twice -> the SAME ModelVersion), lookups fail typed
    with the JAX codes; the fingerprints are the JAX registry's."""
    d1 = _build_model(tmp_path, hidden=16)
    d2 = _build_model(tmp_path, hidden=24)
    reg = _registry()
    v1 = reg.register("m", d1)
    v2 = reg.register("m", d2)
    assert (v1.version, v2.version) == (1, 2)
    assert v1.fingerprint != v2.fingerprint
    assert reg.register("m", d1) is v1          # fingerprint dedupe
    assert len(reg.versions("m")) == 2
    assert reg.get("m") is v2 and reg.latest("m") is v2
    assert reg.get("m", 1) is v1
    assert reg.models() == ["m"]
    assert reg.find_by_fingerprint("m", v2.fingerprint) is v2
    jreg = jax_serving.ModelRegistry()
    assert [jreg.register("m", d).fingerprint for d in (d1, d2)] == \
        [v1.fingerprint, v2.fingerprint]

    with pytest.raises(serving.ModelNotFoundError) as ei:
        reg.get("nope")
    assert ei.value.code == "model_not_found"
    assert isinstance(ei.value, serving.ServingError)
    with pytest.raises(serving.VersionNotFoundError) as ei:
        reg.get("m", 9)
    assert ei.value.code == "version_not_found"
    with pytest.raises(serving.RegistryError) as ei:
        reg.register("bad", str(tmp_path))     # not a saved model
    assert ei.value.code == "registry"
    # prewarm runs every bucket and records the serving fingerprint
    p = v1.prewarm(buckets=(1, 2))
    assert v1.prewarmed and v1.serving_fingerprint is not None
    assert p.program_fingerprint() == v1.serving_fingerprint
    assert p.device.type == "cpu"
    assert reg.to_dict()["m"][0]["prewarmed"]


def test_registry_register_program_serializes(tmp_path):
    """register_program rides the port's io.save_inference_model into the
    registry root and the result round-trips through a Predictor."""
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        pred = pt.layers.fc(x, size=1)
        exe = pt.Executor(pt.CPUPlace())
        exe.run(pt.default_startup_program())
        reg = _registry(root=str(tmp_path / "reg"))
        v = reg.register_program("prog", ["x"], [pred], exe)
        assert v.version == 1 and os.path.isdir(v.model_dir)
        assert v.model_dir == os.path.join(str(tmp_path / "reg"), "prog",
                                           "v1")
        out, = v.make_predictor().run([np.ones((2, 4), np.float32)])
        assert np.asarray(out).shape == (2, 1)
        with pytest.raises(serving.RegistryError):
            serving.ModelRegistry().register_program(
                "p", ["x"], [pred], exe)


def test_registry_persists_and_readopts(tmp_path):
    """ModelRegistry(root) re-adopts its versions from the manifest:
    version numbers and dedupe intact, the manifest written by atomic
    rename and in the JAX registry's layout."""
    d1 = _build_model(tmp_path, hidden=16)
    d2 = _build_model(tmp_path, hidden=32)
    root = str(tmp_path / "registry")
    reg = _registry(root)
    v1 = reg.register("m", d1)
    v2 = reg.register("m", d2)
    v2.prewarm(buckets=(1,))
    reg.save()
    path = os.path.join(root, serving.ModelRegistry.MANIFEST)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    with open(path) as f:
        entries = json.load(f)["models"]["m"]
    assert [e["version"] for e in entries] == [1, 2]
    assert entries[1]["serving_fingerprint"] == v2.serving_fingerprint
    fr = flight_recorder.recorder()
    fr.clear()
    reg2 = _registry(root)
    assert reg2.adopted == 2
    assert ("fleet", "registry_adopted") in [
        (e["category"], e["event"]) for e in fr.events()]
    assert [v.version for v in reg2.versions("m")] == [1, 2]
    assert reg2.get("m").fingerprint == v2.fingerprint
    assert reg2.get("m").serving_fingerprint == v2.serving_fingerprint
    assert not reg2.get("m").prewarmed       # prewarm state not adopted
    assert reg2.get("m", 1).model_dir == d1
    assert reg2.get("m").configure is _cpu
    assert reg2.register("m", d1).version == 1     # dedupe survives
    d3 = _build_model(tmp_path, hidden=64)
    assert reg2.register("m", d3).version == 3
    assert _registry(root).adopted == 3
    # the JAX registry reads the port's manifest (same layout, same
    # fingerprints in one process)
    assert jax_serving.ModelRegistry(root).adopted == 3
    assert v1.version == 1


def test_registry_manifest_fingerprint_mismatch(tmp_path):
    """A model dir rewritten with another program since the manifest was
    written: re-adoption fails with the typed ManifestMismatchError."""
    d1 = _build_model(tmp_path, hidden=16)
    root = str(tmp_path / "registry")
    _registry(root).register("m", d1)
    fluid.framework.switch_main_program(fluid.Program())
    fluid.framework.switch_startup_program(fluid.Program())
    x = layers.data("x", shape=[8], dtype="float32")
    pred = layers.fc(layers.fc(x, size=32, act="relu"), size=1)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    fluid.io.save_inference_model(d1, ["x"], [pred], exe)
    with pytest.raises(serving.ManifestMismatchError) as ei:
        _registry(root)
    assert ei.value.code == "manifest_mismatch"
    assert "fingerprint" in str(ei.value)
    with pytest.raises(jax_serving.ManifestMismatchError):
        jax_serving.ModelRegistry(root)
    # a corrupt manifest is a typed registry error
    with open(os.path.join(root, serving.ModelRegistry.MANIFEST),
              "w") as f:
        f.write("{not json")
    with pytest.raises(serving.RegistryError):
        _registry(root)


def test_registry_configure_and_no_cpu_fallback(tmp_path):
    """A version's Predictors go on the card unless its configure
    callable (its registry's) asks for the CPU: with no card, the default
    load fails typed (nothing reruns on the CPU)."""
    d1 = _build_model(tmp_path, hidden=16)
    v = serving.ModelRegistry().register("m", d1)
    assert v.configure is None
    if not torch.cuda.is_available():
        with pytest.raises(serving.PrewarmFailedError) as ei:
            v.prewarm(buckets=(1,))
        assert ei.value.code == "prewarm_failed"
        assert "predictor load failed" in str(ei.value)
        assert not v.prewarmed
    v.configure = _cpu
    p = v.prewarm(buckets=(1,))
    assert p.device.type == "cpu" and v.prewarmed
    seen = []
    v.configure = lambda c: (seen.append(c.model_dir()), c.disable_gpu())
    assert v.make_predictor().device.type == "cpu"
    assert seen == [d1]


def test_registry_refuses_a_malformed_model_with_ir_verify(tmp_path):
    """With ir_verify on, a saved program that fails the verifier is
    refused at registration (typed RegistryError naming the rule), in
    both packages; with it off, the port registers it."""
    d1 = _build_model(tmp_path, hidden=16)
    path = os.path.join(d1, "__model__")
    with open(path) as f:
        meta = json.load(f)
    meta["program"]["blocks"][0]["ops"][0]["type"] = "no_such_op"
    with open(path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(serving.RegistryError) as ei:
        _registry().register("m", d1)
    assert "unknown-op" in str(ei.value) and "no_such_op" in str(ei.value)
    with pytest.raises(jax_serving.RegistryError) as ei:
        jax_serving.ModelRegistry().register("m", d1)
    assert "unknown-op" in str(ei.value)
    flags.set_flags({"ir_verify": "off"})
    assert _registry().register("m", d1).version == 1


# ---------------------------------------------------------------------------
# the IR verifier, against the JAX package's
# ---------------------------------------------------------------------------

def _diag_rows(diags):
    return [(d.rule, d.severity, d.block_idx, d.op_idx, d.op_type, d.var,
             d.message) for d in diags]


def _lm_programs(tmp_path):
    """(JAX Predictor's post-load program, the port Predictor's) of one
    saved LM."""
    d = _save_lm(tmp_path)
    jpred = jax_inference.create_predictor(jax_inference.Config(d))
    with fresh_port_programs():
        ppred = _predictor(d)
    return jpred._program, ppred._program


def test_verify_lm_post_load_ir_clean_in_both_packages(tmp_path):
    """The LM's post-load program verifies clean in both packages (the
    same warnings, no error), each package's verify over the other's
    program bytes too, and to_bytes/clone keep the fingerprint."""
    jprog, pprog = _lm_programs(tmp_path)
    assert json.dumps(jprog.to_dict(), sort_keys=True) == \
        json.dumps(pprog.to_dict(), sort_keys=True)
    pd = verify(pprog, roundtrip=True)
    jd = jax_verify(jprog, roundtrip=True)
    assert not [d for d in pd if d.severity == "error"]
    assert _diag_rows(pd) == _diag_rows(jd)
    cross = verify(PortProgram.parse_from_bytes(jprog.to_bytes()))
    back = jax_verify(JaxProgram.parse_from_bytes(pprog.to_bytes()))
    assert _diag_rows(cross) == _diag_rows(back) == _diag_rows(pd)
    assert verify_roundtrip(pprog) == []


def _plant_unknown_slot(prog, _names):
    op = prog.global_block().ops[0]
    op.inputs["Bogus"] = list(next(iter(op.inputs.values())))


def _plant_missing_required_attr(prog, _names):
    op = next(o for o in prog.global_block().ops if o.type == "reshape2")
    del op.attrs["shape"]


def _plant_use_before_def(prog, names):
    block = prog.global_block()
    i = next(i for i, o in enumerate(block.ops)
             if o.type == "layer_norm")
    block.ops.insert(0, block.ops.pop(i))


def _plant_unknown_op(prog, _names):
    prog.global_block().ops[1].type = "no_such_op"


def _plant_unregistered_attr(prog, _names):
    prog.global_block().ops[2].attrs["bogus_attr"] = 1


def _plant_duplicate_output(prog, _names):
    op = next(o for o in prog.global_block().ops if o.type == "scale")
    op.outputs["Out"] = op.outputs["Out"] * 2


def _plant_undefined_input(prog, _names):
    op = next(o for o in prog.global_block().ops if o.type == "mul")
    op.inputs["X"] = ["dangling_var"]


def _plant_misparented_var(prog, names):
    block = prog.global_block()
    block.vars[names[0]].name = "renamed"


PLANTS = {
    "unknown-slot": _plant_unknown_slot,
    "unregistered-attr": _plant_missing_required_attr,
    "use-before-def": _plant_use_before_def,
    "unknown-op": _plant_unknown_op,
    "unregistered-attr-extra": _plant_unregistered_attr,
    "duplicate-output": _plant_duplicate_output,
    "undefined-input": _plant_undefined_input,
    "misparented-var": _plant_misparented_var,
}


@pytest.mark.parametrize("fault", list(PLANTS))
def test_verify_names_planted_faults_as_the_jax_verifier(tmp_path, fault):
    """The same fault planted in the same program bytes of both packages:
    both verifiers raise, with the same diagnostics (rule, block, op,
    var, message), the planted rule among them."""
    jprog, _ = _lm_programs(tmp_path)
    data = jprog.to_bytes()
    jp, pp = JaxProgram.parse_from_bytes(data), \
        PortProgram.parse_from_bytes(data)
    names = sorted(jp.global_block().vars)
    for prog in (jp, pp):
        PLANTS[fault](prog, names)
    with pytest.raises(VerifierError) as pe:
        verify(pp, label="planted")
    with pytest.raises(Exception) as je:
        jax_verify(jp, label="planted")
    assert type(je.value).__name__ == "VerifierError"
    assert pe.value.code == "ir_verify" and pe.value.label == "planted"
    rule = fault.replace("-extra", "")
    assert rule in [d.rule for d in pe.value.diagnostics]
    assert _diag_rows(pe.value.diagnostics) == \
        _diag_rows(je.value.diagnostics)
    assert str(pe.value) == str(je.value)


def test_verify_feed_fetch_targets_and_flag_levels(tmp_path):
    """Declared feed/fetch targets are checked as in the JAX verifier;
    the flag's levels normalize as the JAX package's do."""
    jprog, pprog = _lm_programs(tmp_path)
    kw = dict(feeds=["src_ids", "nope_in"], fetches=["nope_out"],
              raise_=False)
    assert _diag_rows(verify(pprog, **kw)) == \
        _diag_rows(jax_verify(jprog, **kw))
    assert {d.rule for d in verify(pprog, **kw)
            if d.severity == "error"} == {"feed-missing", "fetch-missing"}
    for value, level in (("off", "off"), ("on", "on"), ("full", "full"),
                         ("1", "on"), ("true", "on"), ("bogus", "off")):
        flags.set_flags({"ir_verify": value})
        assert verify_level() == level
        assert verify_enabled() == (level != "off")


# ---------------------------------------------------------------------------
# one saved LM loads as one program (the repair the fleet needs)
# ---------------------------------------------------------------------------

def test_two_loads_of_one_lm_give_one_program(tmp_path):
    """Two port loads of one saved LM, with other name draws between
    them, give one fingerprint and one to_dict; the JAX package's two
    loads differ in the fused add's intermediate name."""
    d = _save_lm(tmp_path)
    a = _predictor(d)
    for _ in range(3):
        unique_name.generate("fuse_add_act.inter")
    b = _predictor(d)
    assert a.program_fingerprint() == b.program_fingerprint()
    assert json.dumps(a._program.to_dict(), sort_keys=True) == \
        json.dumps(b._program.to_dict(), sort_keys=True)
    assert "fuse_add_act.inter_0" in a._program.global_block().vars
    j1 = jax_inference.create_predictor(jax_inference.Config(d))
    j2 = jax_inference.create_predictor(jax_inference.Config(d))
    assert j1.program_fingerprint() != j2.program_fingerprint()
    assert json.dumps(j1._program.to_dict(), sort_keys=True) != \
        json.dumps(j2._program.to_dict(), sort_keys=True)
    ids = np.random.RandomState(1).randint(
        0, LM["vocab_size"], (2, LM["max_len"], 1)).astype(np.int64)
    np.testing.assert_array_equal(a.run([ids])[0], b.run([ids])[0])
    np.testing.assert_allclose(a.run([ids])[0], np.asarray(
        j1.run([ids])[0]), rtol=1e-4, atol=1e-4)


def test_pass_names_skip_vars_the_program_holds(tmp_path):
    """A saved program that already holds ``fuse_add_act.inter_0`` (here
    a feed of that name): the fused add's intermediate takes the next
    free name and the Predictor computes relu(x + y)."""
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        y = pt.layers.data("fuse_add_act.inter_0", shape=[4],
                           dtype="float32")
        out = pt.layers.relu(pt.layers.elementwise_add(x, y))
        exe = pt.Executor(pt.CPUPlace())
        exe.run(pt.default_startup_program())
        d = str(tmp_path / "held")
        pt.io.save_inference_model(d, ["x", "fuse_add_act.inter_0"],
                                   [out], exe)
    p = _predictor(d)
    fused = [o for o in p._program.global_block().ops
             if o.type == "fused_elemwise_activation"]
    assert len(fused) == 1
    assert fused[0].outputs["IntermediateOut"] == ["fuse_add_act.inter_1"]
    assert fused[0].inputs["Y"] == ["fuse_add_act.inter_0"]
    rng = np.random.RandomState(2)
    a, b = (rng.standard_normal((3, 4)).astype(np.float32)
            for _ in range(2))
    got, = p.run([a, b])
    np.testing.assert_allclose(got, np.maximum(a + b, 0), rtol=RTOL,
                               atol=ATOL)
    assert not [d for d in verify(p._program) if d.severity == "error"]
    # the pass alone: the same name, and the process counter untouched
    prog = PortProgram.parse_from_bytes(
        PortProgram.from_dict(json.load(open(os.path.join(
            d, "__model__")))["program"]).to_bytes())
    counters = dict(unique_name._counters)
    FuseElewiseAddActTranspiler().transpile(prog)
    assert "fuse_add_act.inter_1" in prog.global_block().vars
    assert unique_name._counters == counters


def test_two_loads_in_two_threads_give_one_program(tmp_path):
    """Two Predictors of the 1-layer LM loaded at once in two threads
    (as a rollout's prewarm and the autoscaler's scale-up do) report one
    fingerprint, and the process-wide name counter is the same object
    with the same counts afterwards."""
    d = _save_lm(tmp_path)
    unique_name.generate("fc")
    counters_obj = unique_name._counters
    counters = dict(counters_obj)
    start = threading.Barrier(2, timeout=30.0)
    fps, errors = [], []

    def load():
        try:
            start.wait()
            for _ in range(3):
                fps.append(_predictor(d).program_fingerprint())
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(fps) == 6 and len(set(fps)) == 1
    assert fps[0] == _predictor(d).program_fingerprint()
    assert unique_name._counters is counters_obj
    assert unique_name._counters == counters


def test_lm_rollout_converges_in_the_port_and_rolls_back_in_jax(tmp_path):
    """A rollout of the 1-layer LM over two replicas (buckets 1 and 2)
    converges in the port: every replica reports the target's serving
    fingerprint and serves its bits.  The same rollout through the JAX
    package rolls back with stragglers, since its prewarms of one
    version report different fingerprints."""
    d1 = _save_lm(tmp_path, d_inner=32, seed=0)
    d2 = _save_lm(tmp_path, d_inner=48, seed=1)
    ids = np.random.RandomState(3).randint(
        0, LM["vocab_size"], (1, LM["max_len"], 1)).astype(np.int64)
    reg = _registry()
    reg.register("lm", d1)
    v2 = reg.register("lm", d2)
    cfg = serving.ServingConfig(n_replicas=2, max_batch=2,
                                default_deadline_s=30.0)
    with serving.InferenceServer(_factory(d1), cfg) as srv:
        res = serving.RolloutController(srv, reg).rollout("lm", 2)
        assert res.converged, res.to_dict()
        assert res.swapped == 2 and res.rolled_back == 0
        assert set(_fps(srv).values()) == {v2.serving_fingerprint}
        assert all(r.version is v2 for r in srv.pool.replicas)
        got, = srv.infer({"src_ids": ids}, timeout=30.0)
        want, = v2.make_predictor().run([ids])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert srv.stats()["accounted"]

    jreg = jax_serving.ModelRegistry()
    jreg.register("lm", d1)
    jreg.register("lm", d2)
    jcfg = jax_serving.ServingConfig(n_replicas=2, max_batch=2,
                                     default_deadline_s=30.0)
    with jax_serving.InferenceServer(
            lambda i: jax_inference.create_predictor(
                jax_inference.Config(d1)), jcfg) as jsrv:
        jres = jax_serving.RolloutController(jsrv, jreg).rollout("lm", 2)
    assert jres.status == "rolled_back", jres.to_dict()
    assert "stragglers" in jres.reason
    assert jres.swapped == jres.rolled_back >= 2


# ---------------------------------------------------------------------------
# the rolling rollout
# ---------------------------------------------------------------------------

def test_rollout_zero_drop_under_live_traffic(tmp_path):
    """A rolling v1 -> v2 swap with traffic in flight: every request
    answered, the fleet converges on v2's serving fingerprint, outputs
    after the swap come from v2 (the JAX Predictor's within the
    tolerance), the fleet instruments and events recorded."""
    d1 = _build_model(tmp_path, hidden=16)
    d2 = _build_model(tmp_path, hidden=24)
    reg = _registry()
    reg.register("m", d1)
    v2 = reg.register("m", d2)
    fleet_events = metrics.registry().get("paddle_tpu_fleet_events_total")
    converged0 = fleet_events.value(event="rollout_converged")
    fr = flight_recorder.recorder()
    fr.clear()
    cfg = serving.ServingConfig(n_replicas=2, max_batch=4,
                                default_deadline_s=10.0)
    with serving.InferenceServer(_factory(d1), cfg) as srv:
        probe = np.ones((1, 8), np.float32)
        before, = srv.infer({"x": probe}, timeout=10.0)
        oracle2, = v2.prewarm(buckets=(1,)).run([probe])
        stop = threading.Event()
        futures = []

        def pump():
            while not stop.is_set():
                try:
                    futures.append(srv.submit({"x": probe}))
                except serving.ServingError:
                    pass
                time.sleep(0.002)

        th = threading.Thread(target=pump, daemon=True)
        th.start()
        time.sleep(0.03)
        res = serving.RolloutController(srv, reg).rollout("m")
        stop.set()
        th.join(timeout=5.0)
        assert res.converged and res.swapped == 2
        assert res.to_dict()["to_version"] == 2 and res.wall_s > 0
        for f in futures:
            f.result(timeout=10.0)
        st = srv.stats()
        assert st["accounted"] and st["outstanding"] == 0
        for r in srv.pool.replicas:
            assert r.predictor.program_fingerprint() == \
                v2.serving_fingerprint
            assert r.version is v2
        after, = srv.infer({"x": probe}, timeout=10.0)
        np.testing.assert_array_equal(after, oracle2)
        assert not np.array_equal(after, before)
        np.testing.assert_allclose(after, np.asarray(
            jax_inference.create_predictor(jax_inference.Config(d2)).run(
                [probe])[0]), rtol=RTOL, atol=ATOL)
        assert srv.stats()["model_version"] == "m@v2"
    assert fleet_events.value(event="rollout_converged") == converged0 + 1
    assert metrics.registry().get("paddle_tpu_fleet_model_version").value(
        model="m") == 2
    chain = [e["event"] for e in fr.events() if e["category"] == "fleet"]
    assert chain.index("rollout_started") < chain.index("replica_swapped") \
        < chain.index("rollout_converged")


def test_rollout_prewarm_failure_leaves_old_serving(tmp_path):
    """A version whose model cannot load surfaces the typed
    PrewarmFailedError with ZERO replicas touched."""
    d1 = _build_model(tmp_path, hidden=16)
    d2 = _build_model(tmp_path, hidden=24)
    reg = _registry()
    reg.register("m", d1)
    reg.register("m", d2)
    os.remove(os.path.join(d2, "__params__.npz")
              if os.path.exists(os.path.join(d2, "__params__.npz"))
              else os.path.join(d2, "__params__"))
    cfg = serving.ServingConfig(n_replicas=2, max_batch=4,
                                default_deadline_s=10.0)
    with serving.InferenceServer(_factory(d1), cfg) as srv:
        fps = _fps(srv)
        rc = serving.RolloutController(srv, reg)
        with pytest.raises(serving.PrewarmFailedError) as ei:
            rc.rollout("m", 2)
        assert ei.value.code == "prewarm_failed"
        assert "v2" in str(ei.value)
        assert _fps(srv) == fps
        assert all(r.version is None for r in srv.pool.replicas)
        srv.infer({"x": np.ones((1, 8), np.float32)}, timeout=10.0)
        assert rc.state == "idle"


def test_rollout_burn_rollback_restores_exact_fingerprint(tmp_path):
    """The burn signal firing mid-rollout rolls every swapped replica
    back to its EXACT prior program fingerprint and bits."""
    d1 = _build_model(tmp_path, hidden=16)
    d2 = _build_model(tmp_path, hidden=24)
    reg = _registry()
    reg.register("m", d1)
    reg.register("m", d2)
    cfg = serving.ServingConfig(n_replicas=3, max_batch=4,
                                default_deadline_s=10.0)
    probe = np.ones((1, 8), np.float32)
    with serving.InferenceServer(_factory(d1), cfg) as srv:
        old_fps = _fps(srv)
        before, = srv.infer({"x": probe}, timeout=10.0)
        rc = serving.RolloutController(srv, reg,
                                       monitor=_FireAfterFirstSwap())
        res = rc.rollout("m", 2)
        assert res.status == "rolled_back"
        assert res.swapped == 1 and res.rolled_back == 1
        assert "burn firing" in res.reason
        assert _fps(srv) == old_fps
        assert set(res.from_fingerprints.values()) <= set(old_fps.values())
        after, = srv.infer({"x": probe}, timeout=10.0)
        np.testing.assert_array_equal(after, before)
        assert rc.state == "rolled_back"
        assert rc.history[-1] is res


def test_rollout_rollback_under_chaos_plan(tmp_path):
    """The burn rollback holds under a seeded fault plan (delayed,
    dropped and closed batches mid-rollout): typed answers for every
    admitted request and the exact old fingerprints restored."""
    d1 = _build_model(tmp_path, hidden=16)
    d2 = _build_model(tmp_path, hidden=24)
    reg = _registry()
    reg.register("m", d1)
    reg.register("m", d2)
    plan = FaultPlan(seed=99, rate=0.1,
                     actions=("drop", "delay=0.01", "close"),
                     max_faults=6)
    cfg = serving.ServingConfig(n_replicas=2, max_batch=4,
                                default_deadline_s=10.0)
    with faultinject.installed(plan):
        with serving.InferenceServer(_factory(d1), cfg) as srv:
            old_fps = _fps(srv)
            futures = [srv.submit({"x": np.ones((1, 8), np.float32)})
                       for _ in range(8)]
            res = serving.RolloutController(
                srv, reg, monitor=_FireAfterFirstSwap()).rollout("m")
            assert res.status == "rolled_back"
            for f in futures:
                try:
                    f.result(timeout=20.0)
                except serving.ServingError:
                    pass                 # a typed answer: accounted
            st = srv.stats()
            assert st["accounted"] and st["outstanding"] == 0
            assert _fps(srv) == old_fps


def test_rollout_converges_through_a_kill(tmp_path):
    """A seeded plan kills a replica after the first swap: the rollout
    still converges, the relaunched replica keeps its swapped program,
    and every admitted request is answered exactly once."""
    d1 = _build_model(tmp_path, hidden=16)
    d2 = _build_model(tmp_path, hidden=24)
    reg = _registry()
    reg.register("m", d1)
    v2 = reg.register("m", d2)
    cfg = serving.ServingConfig(n_replicas=2, max_batch=4,
                                default_deadline_s=10.0,
                                restart_dead=True)
    with serving.InferenceServer(_factory(d1), cfg) as srv:
        plan = FaultPlan().on(serving.MSG_INFER, 0, "kill")

        class KillAfterFirstSwap:
            def __init__(self):
                self.inj = None

            def observe(self):
                if self.inj is None:
                    self.inj = faultinject.install(plan)
                    srv.infer({"x": np.ones((1, 8), np.float32)},
                              timeout=10.0)
                return {}

            def firing(self):
                return []

        mon = KillAfterFirstSwap()
        try:
            res = serving.RolloutController(srv, reg,
                                            monitor=mon).rollout("m")
        finally:
            faultinject.uninstall()
        assert [e[2] for e in mon.inj.log] == ["kill"]
        assert res.converged and res.swapped == 2
        assert srv.pool.counters()["requeues"] >= 1
        t_end = time.monotonic() + 10.0
        while not all(r.alive for r in srv.pool.replicas) and \
                time.monotonic() < t_end:
            time.sleep(0.01)
        assert all(r.alive for r in srv.pool.replicas)
        assert set(_fps(srv).values()) == {v2.serving_fingerprint}
        srv.infer({"x": np.ones((1, 8), np.float32)}, timeout=10.0)
        st = srv.stats()
        assert st["accounted"] and st["outstanding"] == 0


def test_rollout_converges_with_replica_added_mid_rollout(tmp_path):
    """A replica added MID-rollout (not in the snapshot, still serving
    the OLD program) is caught up instead of forcing a rollback."""
    d1 = _build_model(tmp_path, hidden=16)
    d2 = _build_model(tmp_path, hidden=24)
    reg = _registry()
    reg.register("m", d1)
    v2 = reg.register("m", d2)
    cfg = serving.ServingConfig(n_replicas=2, max_batch=4,
                                default_deadline_s=10.0)
    with serving.InferenceServer(_factory(d1), cfg) as srv:

        class AddsReplicaOnFirstPoll:
            def __init__(self):
                self.added = False

            def observe(self):
                if not self.added:
                    self.added = True
                    srv.pool.add_replica()     # the pre-rollout factory
                return {}

            def firing(self):
                return []

        res = serving.RolloutController(
            srv, reg, monitor=AddsReplicaOnFirstPoll()).rollout("m")
        assert res.converged
        assert res.swapped == 3        # 2 snapshotted + 1 late joiner
        live = [r for r in srv.pool.replicas if r.alive and not r.retired]
        assert len(live) == 3
        for r in live:
            assert r.predictor.program_fingerprint() == \
                v2.serving_fingerprint
            assert r.version is v2
        srv.infer({"x": np.ones((1, 8), np.float32)}, timeout=10.0)


def test_scale_up_after_rollout_serves_new_version(tmp_path):
    """A post-rollout scale-up builds the replica FROM the converged
    registry version: its fingerprint matches its tag; the bare
    pool-level path resolves the predictor from the tag too."""
    d1 = _build_model(tmp_path, hidden=16)
    d2 = _build_model(tmp_path, hidden=24)
    reg = _registry()
    reg.register("m", d1)
    v2 = reg.register("m", d2)
    cfg = serving.ServingConfig(n_replicas=1, max_batch=4,
                                default_deadline_s=10.0)
    with serving.InferenceServer(_factory(d1), cfg) as srv:
        res = serving.RolloutController(srv, reg).rollout("m")
        assert res.converged
        sc = serving.SLOAutoscaler(
            srv, _EvalMonitor([_hot()]), min_replicas=1,
            max_replicas=3, up_consecutive=1, down_consecutive=8,
            cooldown_s=0.0)
        assert sc.evaluate() == "up"
        new_rep = srv.pool.replicas[-1]
        assert new_rep.version is v2
        assert new_rep.predictor.program_fingerprint() == \
            v2.serving_fingerprint
        idx = srv.pool.add_replica(version=v2)
        assert srv.pool.replica(idx).predictor.program_fingerprint() == \
            v2.serving_fingerprint
        assert srv.pool.replica(idx).predictor.device.type == "cpu"
        oracle, = v2.prewarm(buckets=(1,)).run(
            [np.ones((1, 8), np.float32)])
        out, = srv.infer({"x": np.ones((1, 8), np.float32)}, timeout=10.0)
        np.testing.assert_array_equal(out, oracle)


# ---------------------------------------------------------------------------
# the SLO-actuated autoscaler
# ---------------------------------------------------------------------------

class _EvalMonitor:
    """Scriptable monitor: feeds a fixed or per-tick evaluation."""

    def __init__(self, evals, name="serving_availability"):
        self.evals = list(evals)
        self.name = name
        self.i = 0

    def observe(self):
        e = self.evals[min(self.i, len(self.evals) - 1)]
        self.i += 1
        return {self.name: e}

    def firing(self):
        return []


def _hot(f=5.0, s=5.0):
    return {"burn_rate_fast": f, "burn_rate_slow": s, "firing": True}


def _cold(f=0.0, s=0.0):
    return {"burn_rate_fast": f, "burn_rate_slow": s, "firing": False}


def _stub_server(n=1):
    pool = serving.ReplicaPool(lambda i: _StubPredictor(),
                               n_replicas=n, health_interval_s=10.0)
    return types.SimpleNamespace(pool=pool, model_version=None)


def test_autoscaler_scale_up_on_sustained_burn_and_clamps():
    srv = _stub_server(1)
    mon = _EvalMonitor([_hot()])
    sc = serving.SLOAutoscaler(srv, mon, min_replicas=1, max_replicas=3,
                               up_consecutive=2, down_consecutive=4,
                               cooldown_s=0.0)
    assert sc.evaluate() is None          # streak 1 < 2
    assert sc.evaluate() == "up"
    assert sc.evaluate() is None and sc.evaluate() == "up"
    assert len(srv.pool.replicas) == 3
    assert sc.evaluate() is None and sc.evaluate() is None
    assert len(srv.pool.replicas) == 3
    assert [d for _, d, _ in sc.scale_events()] == ["up", "up"]
    assert metrics.registry().get("paddle_tpu_fleet_replicas").value() == 3
    with pytest.raises(ValueError):
        serving.SLOAutoscaler(srv, mon, min_replicas=3, max_replicas=1)
    with pytest.raises(ValueError):
        serving.SLOAutoscaler(srv, mon, burn_up=1.0, burn_clear=2.0)


def test_autoscaler_cooldown_blocks_consecutive_actions():
    srv = _stub_server(1)
    sc = serving.SLOAutoscaler(srv, _EvalMonitor([_hot()]),
                               min_replicas=1, max_replicas=4,
                               up_consecutive=1, down_consecutive=4,
                               cooldown_s=60.0)
    assert sc.evaluate() == "up"
    assert sc.evaluate() is None and sc.evaluate() is None
    assert len(srv.pool.replicas) == 2


def test_autoscaler_hysteresis_never_flaps_on_oscillating_load():
    """Strict hot/cold alternation and a mid-band burn produce no
    action, in the port as in the JAX package."""
    evals = [_hot() if i % 2 == 0 else _cold() for i in range(40)]
    evals += [{"burn_rate_fast": 1.0, "burn_rate_slow": 1.0,
               "firing": False}] * 20
    srv = _stub_server(2)
    kw = dict(min_replicas=1, max_replicas=4, up_consecutive=2,
              down_consecutive=2, burn_up=2.0, burn_clear=0.5,
              cooldown_s=0.0)
    sc = serving.SLOAutoscaler(srv, _EvalMonitor(evals), **kw)
    actions = [sc.evaluate() for _ in range(len(evals))]
    assert all(a is None for a in actions), actions
    assert len(srv.pool.replicas) == 2 and sc.scale_events() == []
    jpool = jax_serving.ReplicaPool(lambda i: _StubPredictor(),
                                    n_replicas=2, health_interval_s=10.0)
    jsc = jax_serving.SLOAutoscaler(
        types.SimpleNamespace(pool=jpool, model_version=None),
        _EvalMonitor(evals), **kw)
    assert [jsc.evaluate() for _ in range(len(evals))] == actions


def test_autoscaler_scale_down_graceful_drain_answers_inflight(tmp_path):
    """Scale-down retires a replica THROUGH the quiesce: every request
    answered, the retiree never resurrected, the last replica kept."""
    d1 = _build_model(tmp_path, hidden=16)
    cfg = serving.ServingConfig(n_replicas=2, max_batch=2,
                                default_deadline_s=10.0,
                                queue_capacity=32, restart_dead=True)
    with serving.InferenceServer(_factory(d1), cfg) as srv:
        futures = [srv.submit({"x": np.ones((1, 8), np.float32)})
                   for _ in range(12)]
        sc = serving.SLOAutoscaler(
            srv, _EvalMonitor([_cold()]), min_replicas=1,
            max_replicas=3, up_consecutive=2, down_consecutive=1,
            cooldown_s=0.0)
        assert sc.evaluate() == "down"
        for f in futures:
            f.result(timeout=10.0)
        st = srv.stats()
        assert st["accounted"] and st["outstanding"] == 0
        assert len(srv.pool.replicas) == 1
        time.sleep(0.15)
        assert len(srv.pool.replicas) == 1
        assert sc.evaluate() is None
        assert len(srv.pool.replicas) == 1
        srv.infer({"x": np.ones((1, 8), np.float32)}, timeout=10.0)


def test_autoscaler_reads_a_live_slo_monitor(tmp_path):
    """The autoscaler on a real SLOMonitor of fleet_availability: quota
    sheds and overload sheds burn the budget and scale up (through the
    version's prewarm), a quiet signal scales down; the background loop
    starts and stops."""
    d1 = _build_model(tmp_path, hidden=16)
    v1 = _registry().register("m", d1)
    reg = metrics.MetricsRegistry()
    c = reg.counter("paddle_tpu_admission_requests_total")
    mon = slo.SLOMonitor(slos=[slo.fleet_availability(
        objective=0.99, window_s=60.0, fast_fraction=0.5)], registry=reg)
    cfg = serving.ServingConfig(n_replicas=1, max_batch=4,
                                default_deadline_s=10.0)
    with serving.InferenceServer(_factory(d1), cfg) as srv:
        srv.model_version = v1
        sc = serving.SLOAutoscaler(
            srv, mon, slo="fleet_availability", min_replicas=1,
            max_replicas=2, up_consecutive=2, down_consecutive=2,
            cooldown_s=0.0)
        assert sc.evaluate() is None            # one sample: no rate
        for _ in range(2):
            c.inc(10, outcome="admitted")
            c.inc(10, outcome="answered_ok")
            c.inc(5, outcome="rejected_quota")
            c.inc(5, outcome="rejected_overloaded")
            action = sc.evaluate()
        assert action == "up" and len(srv.pool.replicas) == 2
        new = srv.pool.replicas[-1]
        assert new.version is v1 and v1.prewarmed
        assert new.predictor.program_fingerprint() == v1.serving_fingerprint
        assert "fleet_availability" in mon.firing()
        sc2 = serving.SLOAutoscaler(
            srv, slo.SLOMonitor(slos=[slo.fleet_availability(
                objective=0.99, window_s=60.0)],
                registry=metrics.MetricsRegistry()),
            slo="fleet_availability", min_replicas=1, max_replicas=2,
            down_consecutive=2, cooldown_s=0.0)
        assert sc2.evaluate() is None and sc2.evaluate() == "down"
        assert len(srv.pool.replicas) == 1
        sc2.start(interval_s=0.01)
        time.sleep(0.05)
        sc2.stop()
        assert sc2._thread is None
        srv.infer({"x": np.ones((1, 8), np.float32)}, timeout=10.0)
        assert srv.stats()["accounted"]


# ---------------------------------------------------------------------------
# the SLO engine, against the JAX package's
# ---------------------------------------------------------------------------

def _counter_slo(mod, reg_name="paddle_tpu_t_slo_reqs_total", **kw):
    return mod.SLO("t_availability", 0.9, 60.0, source={
        "kind": "counter_ratio", "metric": reg_name,
        "good": [{"outcome": "ok"}],
        "total": [{"outcome": "ok"}, {"outcome": "shed"}]}, **kw)


def test_slo_validation_and_histogram_source():
    with pytest.raises(ValueError):
        slo.SLO("bad", 1.5, 60.0, source={"kind": "counter_ratio",
                                          "metric": "m", "good": [],
                                          "total": []})
    with pytest.raises(ValueError):
        slo.SLO("bad", 0.9, 60.0, source={"kind": "nope"})
    samples = []
    for mod, mmod in ((slo, metrics), (jax_slo, jax_metrics)):
        r = mmod.MetricsRegistry()
        h = r.histogram("paddle_tpu_t_lat_seconds")
        for v in (0.01, 0.02, 0.05, 0.25, 1.0):
            h.observe(v)
        s = mod.SLO("lat", 0.9, 60.0, source={
            "kind": "histogram_under",
            "metric": "paddle_tpu_t_lat_seconds", "threshold_s": 0.25})
        samples.append(s.sample(r))
        assert mod.SLO("none", 0.9, 60.0, source={
            "kind": "histogram_under", "metric": "absent",
            "threshold_s": 1.0}).sample(r) == (0.0, 0.0)
    assert samples[0] == samples[1]
    good, total = samples[0]
    assert total == 5 and good == 4          # the 1.0 s one is bad


def test_slo_burn_rate_fires_and_clears_with_flight_events():
    """A shed-heavy phase fires the multi-window alert, a recovery phase
    clears it: both packages' monitors, fed the same counts at the same
    times, give the same evaluations; the port's transitions land in its
    flight recorder and gauges and round-trip through a dump."""
    monitors = []
    for mod, mmod in ((slo, metrics), (jax_slo, jax_metrics)):
        r = mmod.MetricsRegistry()
        monitors.append((r.counter("paddle_tpu_t_slo_reqs_total"),
                         mod.SLOMonitor(slos=[_counter_slo(
                             mod, fast_fraction=0.25, burn_alert=2.0)],
                             registry=r)))
    fr = flight_recorder.recorder()
    fr.clear()
    t = 1000.0
    schedule = [(0, 0)] + [(20, 0)] * 6 + [(10, 10)] * 8 + [(20, 0)] * 12
    fired = cleared = False
    for i, (ok, shed) in enumerate(schedule):
        t += 10.0 if i else 0.0
        evs = []
        for c, mon in monitors:
            if ok:
                c.inc(ok, outcome="ok")
            if shed:
                c.inc(shed, outcome="shed")
            evs.append(mon.observe(now=t)["t_availability"])
        assert evs[0] == evs[1], (i, evs)
        ev = evs[0]
        if i == 0:
            assert ev["burn_rate_slow"] is None and not ev["firing"]
        if i == 6:
            assert ev["attained"] == 1.0 and not ev["firing"]
        if i == 14:
            assert ev["firing"], ev
            assert ev["burn_rate_fast"] >= 2.0 and \
                ev["burn_rate_slow"] >= 2.0
            assert metrics.registry().get(
                "paddle_tpu_slo_alert_firing").value(
                slo="t_availability") == 1.0
            assert monitors[0][1].firing() == ["t_availability"]
            fired = True
        if fired and not ev["firing"]:
            cleared = True
    assert fired and cleared
    assert metrics.registry().get("paddle_tpu_slo_alert_firing").value(
        slo="t_availability") == 0.0
    chain = [(e["category"], e["event"]) for e in fr.events()]
    assert chain.index(("slo", "alert_firing")) < \
        chain.index(("slo", "alert_cleared"))
    path = fr.dump(reason="slo_test", announce=False)
    assert path is not None
    dumped = [(e["category"], e["event"])
              for e in flight_recorder.load_dump(path)["events"]]
    assert ("slo", "alert_firing") in dumped
    assert ("slo", "alert_cleared") in dumped
    mon = monitors[0][1]
    doc = mon.sloz(observe=False)
    assert doc["firing"] == [] and doc["slos"][0]["name"] == \
        "t_availability"
    assert set(mon.verdict()["t_availability"]) == {
        "attained", "target", "burn_rate", "firing"}


def test_slo_factories_hooks_and_window_env(monkeypatch):
    """The canned objectives are the JAX package's (names, sources,
    windows); default_slos, the process hooks and PADDLE_TPU_SLO_WINDOW
    behave alike."""
    for name in ("serving_availability", "serving_latency",
                 "fleet_availability", "decode_inter_token"):
        got = getattr(slo, name)(window_s=30.0).to_dict()
        want = getattr(jax_slo, name)(window_s=30.0).to_dict()
        assert got == want, name
    assert [s.name for s in slo.default_slos()] == \
        [s.name for s in jax_slo.default_slos()]
    monkeypatch.setenv("PADDLE_TPU_SLO_WINDOW", "42")
    assert slo.default_window() == 42.0
    assert slo.serving_availability().window_s == 42.0
    monkeypatch.delenv("PADDLE_TPU_SLO_WINDOW")
    assert slo.default_window() == 300.0
    prev = slo._monitor
    try:
        slo.install(None)
        assert slo.peek_firing() == []
        m = slo.monitor()
        assert isinstance(m, slo.SLOMonitor) and slo.monitor() is m
        assert [s.name for s in m.slos] == [
            "serving_availability", "serving_p99_deadline",
            "decode_inter_token_p99"]
        assert slo.install(m) is m and slo.peek_firing() == []
        m.start(interval_s=0.01)
        time.sleep(0.05)
        m.stop()
        assert m._thread is None
    finally:
        slo.install(prev)


def test_serving_request_latency_histogram_feeds_slo(tmp_path):
    """The port's admission layer observes per-request latency, the
    p99-vs-deadline SLO's source, and its counter feeds the availability
    objectives."""
    reg = metrics.registry()
    h0 = reg.get("paddle_tpu_serving_request_seconds")
    n0 = 0 if h0 is None else sum(s["count"] for _, s in h0.items())
    lat0 = slo.serving_latency(deadline_s=30.0).sample(reg)
    avail0 = slo.fleet_availability().sample(reg)
    d = _build_model(tmp_path, hidden=16)
    srv = serving.InferenceServer(
        _factory(d), serving.ServingConfig(n_replicas=1, max_batch=2)
    ).start()
    try:
        srv.infer({"x": np.zeros((1, 8), np.float32)}, deadline_s=30.0,
                  timeout=30.0)
    finally:
        srv.stop()
    h = reg.get("paddle_tpu_serving_request_seconds")
    assert sum(s["count"] for _, s in h.items()) > n0
    good, total = slo.serving_latency(deadline_s=30.0).sample(reg)
    assert total >= lat0[1] + 1 and good >= lat0[0] + 1
    good, total = slo.fleet_availability().sample(reg)
    assert good == avail0[0] + 1 and total == avail0[1] + 1


def test_fleet_module_surface():
    """The exported names, codes and result shape of the JAX package."""
    for name in ("ModelRegistry", "ModelVersion", "RolloutController",
                 "RolloutResult", "SLOAutoscaler", "RegistryError",
                 "ModelNotFoundError", "VersionNotFoundError",
                 "PrewarmFailedError", "ManifestMismatchError",
                 "RolloutError"):
        assert name in serving.__all__ and name in jax_serving.__all__
        port, ref = getattr(serving, name), getattr(jax_serving, name)
        assert getattr(port, "code", None) == getattr(ref, "code", None)
    assert issubclass(serving.PrewarmFailedError, serving.RegistryError)
    assert issubclass(serving.RolloutError, serving.ServingError)
    v = port_registry.ModelVersion("m", 3, "/nowhere", 7)
    res = serving.RolloutResult("converged", "m", v, 2, wall_s=0.5)
    assert res.converged and res.to_dict() == {
        "status": "converged", "model": "m", "to_version": 3,
        "to_fingerprint": "7", "swapped": 2, "rolled_back": 0,
        "reason": "", "wall_s": 0.5}
    assert repr(v) == "m@v3"
