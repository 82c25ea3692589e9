"""The port's CompiledProgram on the CPU, where its plan runs eagerly.

- Compiled against interpreted, bitwise: the LM's f32 step (2 layers,
  d_model 64) and its AMP step (flag ``fc_epilogue`` "interpret") over 3
  steps, and a small ResNet's conv_bn_stats AMP step (flag
  ``conv_bn_stats`` "interpret"): every loss and every persistable after
  the steps.  The plan runs the interpreter's computes in its order, so
  anything short of equal is a fault.
- Against the JAX package: the port's CompiledProgram and the JAX
  package's, on the same LM program serialised by ``to_bytes``, from the
  same weights.  Losses within rtol=atol=1e-5 and parameters after 3 Adam
  steps within ``2 * lr`` a step plus 1e-4 (the bars of
  ``test_torch_train.py``: per-op f32 against XLA's f32 in other orders,
  and Adam's update near ``lr * sign(g)`` for a tiny grad).
- The fingerprint: equal programs hash equal; an attr edit through
  ``set_attr``, another var width and an appended op change the hash; the
  port's and the JAX package's fingerprints agree on which of a set of
  edits change it.
- The cache: ``paddle_tpu_executor_compiles_total`` rises once for each
  new (feed shapes, fetch names, fingerprint) and not on a repeat, the
  Predictor's batch-dim wildcard included; a compile and a step are
  recorded (the flight recorder, the spans, the step histogram).
- State and fetches: persistables keep their tensors (``data_ptr``)
  across runs, a tensor set in a persistable's place is copied into its
  buffer, and a fetch from run n is unchanged after run n+1.
- Host ops: a host-only op registered here splits the plan into two
  segments and runs between them; an unproducible one poisons its
  outputs.  Refusals: two places, sharding rules, an uninitialised
  persistable, a ``while`` op.
- Capture-safe constants: the op computes build their 0-d constants with
  ``torch.full`` (no host copy, so a CUDA graph can capture them); the
  values each site takes give the same bits as ``torch.tensor`` did.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.compiler import program_fingerprint as jax_fingerprint
from paddle_tpu.core.program import Program as JaxProgram
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.core.scope import scope_guard as jax_scope_guard
from torch_port_helpers import TINY_LM, fresh_port_programs, to_numpy

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import compiler
from paddle_tpu_torch.core.program import OpDesc
from paddle_tpu_torch.core.program import Program as PortProgram
from paddle_tpu_torch.core.registry import (_REGISTRY, get_op_def,
                                            register_op)

port_resnet = importlib.import_module("paddle_tpu_torch.models.resnet")
LR = 1e-3
STEPS = 3
GRAD_TOL = 1e-4
PARAM_ATOL = 2 * LR * STEPS + GRAD_TOL
TRAIN_LM = dict(TINY_LM, is_test=False)


def _lm_feed(seed=6, batch=2):
    rng = np.random.RandomState(seed)
    shape = (batch, TRAIN_LM["max_len"], 1)
    return {n: rng.randint(0, TRAIN_LM["vocab_size"], shape).astype(
        np.int64) for n in ("src_ids", "tgt_label")}


def _build_lm(amp):
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    model = transformer_encoder_model(**TRAIN_LM)
    main = pt.default_main_program()
    if amp:
        pt.transpiler.fuse_epilogue(main, protected=[model["loss"].name],
                                    anchors=("fc",))
        decorate(pt.optimizer.Adam(LR, fuse=True), init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False).minimize(model["loss"])
    else:
        pt.optimizer.Adam(LR).minimize(model["loss"])
    return model["loss"].name, main, _lm_feed()


def _build_resnet():
    L = pt.layers
    image = L.data("image", shape=[3, 32, 32], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    x = port_resnet._conv_bn(image, 8, 7, stride=2, act="relu")
    x = L.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                 pool_type="max")
    x = port_resnet._bottleneck(x, 4, 2)
    x = port_resnet._bottleneck(x, 4, 1)
    logits = L.fc(L.pool2d(x, pool_type="avg", global_pooling=True),
                  size=10)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    acc = L.accuracy(L.softmax(logits), label)
    main = pt.default_main_program()
    pt.transpiler.fuse_conv_bn_train(
        main, protected=[loss.name, logits.name, acc.name])
    pt.transpiler.nhwc_transpile(main)
    pt.contrib.mixed_precision.decorate(
        pt.optimizer.Momentum(0.1, 0.9), init_loss_scaling=1.0,
        use_dynamic_loss_scaling=False).minimize(loss)
    rng = np.random.RandomState(1)
    feed = {"image": rng.rand(2, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    return loss.name, main, feed


@contextlib.contextmanager
def _flag(name, mode):
    pt.set_flags({name: mode})
    try:
        yield
    finally:
        pt.set_flags({name: "off"})


def _persistables(main):
    return sorted(v.name for v in main.persistables() if not v.is_data)


def _state(scope, names):
    return {n: scope.find_var(n).get().clone() for n in names}


def _steps(main, startup, feed, loss, compiled, steps=STEPS):
    """``steps`` steps from the startup program's state (seed 0): the
    losses, the persistables after, and the compiled program."""
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    np.random.seed(0)
    exe.run(startup, scope=scope)
    prog = pt.CompiledProgram(main) if compiled else main
    losses = [exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)[0]
              for _ in range(steps)]
    return losses, _state(scope, _persistables(main)), prog


BUILDS = {"lm_f32": (lambda: _build_lm(False), None),
          "lm_amp": (lambda: _build_lm(True), "fc_epilogue"),
          "resnet_amp": (_build_resnet, "conv_bn_stats")}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_compiled_equals_interpreted_bitwise(case):
    build, flag = BUILDS[case]
    with fresh_port_programs(), (
            _flag(flag, "interpret") if flag else contextlib.nullcontext()):
        loss, main, feed = build()
        startup = pt.default_startup_program()
        want_losses, want_state, _ = _steps(main, startup, feed, loss, False)
        got_losses, got_state, prog = _steps(main, startup, feed, loss, True)
    assert np.isfinite(want_losses).all()
    for got, want in zip(got_losses, want_losses):
        np.testing.assert_array_equal(got, want)
    assert sorted(got_state) == sorted(want_state)
    unequal = [n for n in want_state
               if not torch.equal(got_state[n], want_state[n])]
    assert unequal == []
    # one key: one plan, built once and run eagerly every step
    assert prog.graph_stats() == {"entries": 1, "graphs": 0, "replays": 0}


def test_compiled_matches_the_jax_compiled_program():
    with fresh_port_programs():
        loss, main, feed = _build_lm(False)
        startup = pt.default_startup_program()
        exe = pt.Executor(pt.CPUPlace())
        scope = pt.Scope()
        np.random.seed(0)
        exe.run(startup, scope=scope)
        names = _persistables(main)
        start = {n: to_numpy(scope.find_var(n).get()).copy() for n in names}
        prog = pt.CompiledProgram(main)
        port_losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]) for _ in range(STEPS)]
        port_end = {n: to_numpy(scope.find_var(n).get()) for n in names}
        jmain = JaxProgram.parse_from_bytes(main.to_bytes())
    jexe = fluid.Executor(fluid.CPUPlace())
    with jax_scope_guard(JaxScope()):
        jscope = fluid.global_scope()
        for n, arr in start.items():
            jscope.var(n).set(arr)
        jprog = fluid.CompiledProgram(jmain)
        jax_losses = [float(jexe.run(jprog, feed=feed, fetch_list=[loss])[0])
                      for _ in range(STEPS)]
        jax_end = {n: np.asarray(jscope.find_var(n).get()) for n in names}
    assert port_losses[-1] < port_losses[0]
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5,
                               atol=1e-5)
    for n in names:
        is_moment = "_moment" in n or "_beta" in n
        np.testing.assert_allclose(
            port_end[n], jax_end[n], rtol=GRAD_TOL if is_moment else 0,
            atol=GRAD_TOL if is_moment else PARAM_ATOL, err_msg=n)


# ---------------------------------------------------------------------------
# the fingerprint
# ---------------------------------------------------------------------------

def _mlp_dict(width=8):
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        y = pt.layers.fc(pt.layers.fc(x, size=width, act="relu"), size=2)
        pt.layers.mean(y)
        return pt.default_main_program().to_dict()


def _set_attr(prog):
    op = next(o for o in prog.global_block().ops if o.type == "mul")
    op.set_attr("x_num_col_dims", 2)


def _same_attr(prog):
    op = next(o for o in prog.global_block().ops if o.type == "mul")
    op.set_attr("x_num_col_dims", op.attrs["x_num_col_dims"])


def _append(prog):
    b = prog.global_block()
    mean = b.ops[-1].outputs["Out"][0]
    out = b.create_var(name="extra_out", shape=(1,), dtype="float32")
    b.ops.append(type(b.ops[-1])("scale", {"X": [mean]}, {"Out": [out.name]},
                                 {"scale": 2.0, "bias": 0.0,
                                  "bias_after_scale": True}))


def _width(prog):
    v = next(v for v in prog.global_block().vars.values() if v.persistable)
    v.shape = tuple(v.shape[:-1]) + (v.shape[-1] + 1,)


def _sharding(prog):
    v = next(v for v in prog.global_block().vars.values() if v.persistable)
    v.set_sharding((None, "tp"))


def _persistable_flip(prog):
    v = next(v for v in prog.global_block().vars.values()
             if not v.persistable)
    v.persistable = True


def _role(prog):
    prog.global_block().ops[0].op_role = "backward"


def _seed(prog):
    prog.random_seed = 7


EDITS = {"none": lambda p: None, "set_attr": _set_attr,
         "same_attr": _same_attr, "append_op": _append, "width": _width,
         "sharding": _sharding, "persistable": _persistable_flip,
         "op_role": _role, "random_seed": _seed}


def test_fingerprint_of_equal_programs_is_equal():
    a = PortProgram.from_dict(_mlp_dict())
    b = PortProgram.from_dict(_mlp_dict())
    assert compiler.program_fingerprint(a) == \
        compiler.program_fingerprint(b)
    assert compiler.program_fingerprint(a) != \
        compiler.program_fingerprint(PortProgram.from_dict(_mlp_dict(16)))


def test_fingerprint_memo_sees_set_attr_and_appended_ops():
    prog = PortProgram.from_dict(_mlp_dict())
    base = compiler.program_fingerprint(prog)
    op = next(o for o in prog.global_block().ops if o.type == "mul")
    old = op.attrs["x_num_col_dims"]
    op.set_attr("x_num_col_dims", old + 1)
    assert compiler.program_fingerprint(prog) != base
    op.set_attr("x_num_col_dims", old)
    assert compiler.program_fingerprint(prog) == base
    _append(prog)
    assert compiler.program_fingerprint(prog) != base


def test_fingerprints_agree_with_jax_on_which_edits_change_them():
    """Each edit on a fresh copy of one program, in each package: the
    two agree edit by edit, and op roles and the random seed are not part
    of a program's identity."""
    d = _mlp_dict()
    changed = {}
    for name, edit in EDITS.items():
        row = []
        for cls, fp in ((PortProgram, compiler.program_fingerprint),
                        (JaxProgram, jax_fingerprint)):
            prog = cls.from_dict(d)
            edit(prog)
            row.append(fp(prog) != fp(cls.from_dict(d)))
        changed[name] = row
    assert all(p == j for p, j in changed.values()), changed
    assert {n for n, (p, _) in changed.items() if p} == {
        "set_attr", "append_op", "width", "sharding", "persistable"}


# ---------------------------------------------------------------------------
# the cache, state and fetches
# ---------------------------------------------------------------------------

def _sgd_mlp():
    """A small MLP trained by SGD in fresh programs: (main, startup,
    loss name, a parameter's name, the hidden activation's name)."""
    x = pt.layers.data("x", shape=[4], dtype="float32")
    h = pt.layers.fc(x, size=8, act="relu")
    loss = pt.layers.mean(pt.layers.fc(h, size=2))
    pt.optimizer.SGD(0.5).minimize(loss)
    main = pt.default_main_program()
    w = next(v.name for v in main.all_parameters())
    return main, pt.default_startup_program(), loss.name, w, h.name


def _x(batch, seed=0):
    return np.random.RandomState(seed).rand(batch, 4).astype(np.float32)


def test_compiles_once_for_each_new_key():
    count = compiler._M_COMPILES.value
    with fresh_port_programs():
        main, startup, loss, w, _ = _sgd_mlp()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        prog = pt.CompiledProgram(main)
        seen = []
        for batch, fetch in ((2, [loss]), (2, [loss]), (3, [loss]),
                             (2, [loss]), (2, [loss, w]), (3, [loss])):
            before = count()
            exe.run(prog, feed={"x": _x(batch)}, fetch_list=fetch)
            seen.append(count() - before)
        assert seen == [1, 0, 1, 0, 1, 0]
        block = main.global_block()            # a new fingerprint
        block.append_op("scale", inputs={"X": [loss]},
                        outputs={"Out": [block.create_var(name="loss_x2")]},
                        attrs={"scale": 2.0})
        before = count()
        exe.run(prog, feed={"x": _x(2)}, fetch_list=[loss])
        assert count() - before == 1
        assert prog.graph_stats()["entries"] == 4


def test_compile_and_step_are_instrumented():
    """A cache miss counts a compile, records the flight recorder's
    ("executor", "compile") event and, with a tracer installed, an
    ``executor.compile`` span; a hit an ``executor.step`` span; both
    observe the step histogram."""
    from paddle_tpu_torch.observability import flight_recorder, tracing

    steps = compiler._M_STEP_SECONDS.labels()
    with fresh_port_programs():
        main, startup, loss, _, _ = _sgd_mlp()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        prog = pt.CompiledProgram(main)
        observed = steps.count
        tracer = tracing.start_tracing(sample=1.0)
        try:
            tracer.clear()
            for _ in range(2):
                exe.run(prog, feed={"x": _x(2)}, fetch_list=[loss])
            names = [sp.name for sp in tracer.spans()]
        finally:
            tracing.stop_tracing()
    assert names == ["executor.compile", "executor.step"]
    assert steps.count == observed + 2
    last = [e for e in flight_recorder.recorder().events()
            if e["category"] == "executor"][-1]
    assert last["event"] == "compile" and last["n_feeds"] == 1 and \
        last["n_fetch"] == 1


def test_persistables_keep_their_buffers():
    with fresh_port_programs():
        main, startup, loss, w, _ = _sgd_mlp()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        scope = pt.global_scope()
        prog = pt.CompiledProgram(main)
        exe.run(prog, feed={"x": _x(2)}, fetch_list=[loss])
        names = _persistables(main)
        ptrs = {n: scope.find_var(n).get().data_ptr() for n in names}
        before = scope.find_var(w).get().clone()
        for _ in range(3):
            exe.run(prog, feed={"x": _x(2)}, fetch_list=[loss])
        assert {n: scope.find_var(n).get().data_ptr() for n in names} == ptrs
        assert not torch.equal(scope.find_var(w).get(), before)
        # a tensor set in the buffer's place is copied into the buffer
        buf = scope.find_var(w).get()
        scope.var(w).set(torch.zeros_like(buf))
        exe.run(prog, feed={"x": _x(2)}, fetch_list=[loss])
        assert scope.find_var(w).get() is buf
        assert float(buf.abs().max()) < float(before.abs().max())


@pytest.mark.parametrize("return_numpy", [True, False])
def test_fetches_survive_the_next_run(return_numpy):
    with fresh_port_programs():
        main, startup, loss, w, h = _sgd_mlp()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        prog = pt.CompiledProgram(main)
        fetch = [loss, w, h]
        first = exe.run(prog, feed={"x": _x(2)}, fetch_list=fetch,
                        return_numpy=return_numpy)
        kept = [np.array(to_numpy(v)) for v in first]
        second = exe.run(prog, feed={"x": _x(2, 1)}, fetch_list=fetch,
                         return_numpy=return_numpy)
        for v, k in zip(first, kept):
            np.testing.assert_array_equal(to_numpy(v), k)
        # the parameter moved, and the second run fetched its new value
        assert not np.array_equal(to_numpy(second[1]), kept[1])


def test_predictor_builds_one_entry_for_each_batch_shape(tmp_path):
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        y = pt.layers.fc(pt.layers.fc(x, size=8, act="relu"), size=3)
        exe = pt.Executor(pt.CPUPlace())
        np.random.seed(0)
        exe.run(pt.default_startup_program())
        pt.io.save_inference_model(str(tmp_path), ["x"], [y], exe)
    cfg = pt.inference.Config(str(tmp_path))
    cfg.disable_gpu()
    pred = pt.inference.create_predictor(cfg)
    count = compiler._M_COMPILES.value
    seen = []
    outs = {}
    for batch in (2, 2, 3, 2, 3):
        before = count()
        out, = pred.run([_x(batch)])
        outs.setdefault(batch, out)
        np.testing.assert_array_equal(out, outs[batch])
        seen.append(count() - before)
    assert seen == [1, 0, 1, 0, 0]
    assert pred._compiled.graph_stats()["entries"] == 2
    ref, = pt.Executor(pt.CPUPlace()).run(
        pred._program, feed={"x": _x(3)}, fetch_list=pred._fetch_vars,
        scope=pred._scope)
    np.testing.assert_array_equal(outs[3], ref)


# ---------------------------------------------------------------------------
# host ops and refusals
# ---------------------------------------------------------------------------

HOST_CALLS = []

if "_test_host_double" not in _REGISTRY:
    @register_op("_test_host_double", inputs=("X",), outputs=("Out",),
                 host_only=True, differentiable=False)
    def _host_double(ins, attrs, device):
        HOST_CALLS.append(1)
        return {"Out": torch.from_numpy(ins["X"].cpu().numpy() * 2.0).to(
            device)}


def _host_program(source=None):
    """fc -> the host op -> fc -> mean; ``source`` replaces the host op's
    input with a var nothing produces."""
    x = pt.layers.data("x", shape=[4], dtype="float32")
    h = pt.layers.fc(x, size=3)
    block = pt.default_main_program().global_block()
    d = block.create_var(name="doubled", shape=h.shape, dtype="float32")
    block.append_op("_test_host_double", inputs={"X": [source or h.name]},
                    outputs={"Out": [d]})
    out = pt.layers.mean(pt.layers.fc(d, size=2))
    return out.name


def test_host_op_splits_the_plan_and_runs_between_segments():
    with fresh_port_programs():
        out = _host_program()
        main = pt.default_main_program()
        exe = pt.Executor(pt.CPUPlace())
        np.random.seed(0)
        exe.run(pt.default_startup_program())
        want = exe.run(main, feed={"x": _x(2)}, fetch_list=[out])[0]
        prog = pt.CompiledProgram(main)
        calls = len(HOST_CALLS)
        for _ in range(2):
            got = exe.run(prog, feed={"x": _x(2)}, fetch_list=[out])[0]
            np.testing.assert_array_equal(got, want)
        assert len(HOST_CALLS) == calls + 2
        entry, = prog._cache.values()
        assert [type(i).__name__ for i in entry.items] == [
            "_Segment", "_HostOp", "_Segment"]


def test_host_op_without_its_input_poisons_its_outputs():
    with fresh_port_programs():
        out = _host_program(source="never_produced")
        block = pt.default_main_program().global_block()
        block.create_var(name="never_produced", shape=(-1, 3),
                         dtype="float32")
        exe = pt.Executor(pt.CPUPlace())
        exe.run(pt.default_startup_program())
        prog = pt.CompiledProgram(pt.default_main_program())
        with pytest.raises(RuntimeError,
                           match="'doubled' is unavailable .* host-only"):
            exe.run(prog, feed={"x": _x(2)}, fetch_list=[out])


def test_refusals():
    with fresh_port_programs():
        main, startup, loss, _, _ = _sgd_mlp()
        prog = pt.CompiledProgram(main)
        # one process drives one device: more places than the world raise,
        # naming the launcher
        with pytest.raises(NotImplementedError,
                           match="paddle_tpu_torch.launch --nproc_per_node"):
            prog.with_data_parallel(
                loss_name=loss, places=[pt.CUDAPlace(0), pt.CUDAPlace(1)])
        # any rule is taken, a parameter sharded (ZeRO stage 3) too; a
        # spec naming an axis the mesh has not raises, as in the JAX
        # package
        from paddle_tpu_torch.parallel.zero import (PartitionSpec,
                                                    zero_sharding_rules)
        assert prog.with_sharding_rules(lambda name, shape: None) is prog
        assert prog.with_sharding_rules(
            zero_sharding_rules(stage=3, min_size=1, program=main)) is prog
        params = {v.name for v in main.all_parameters()}
        with pytest.raises(ValueError, match="unknown mesh axis 'tp'"):
            prog.with_sharding_rules(
                lambda name, shape: PartitionSpec("tp")
                if name not in params and len(shape) == 1 else None)
        assert prog.with_data_parallel(loss_name=loss) is prog
        exe = pt.Executor(pt.CPUPlace())
        with pytest.raises(RuntimeError, match=(
                r"persistable '.*' is uninitialized — run the startup "
                r"program first")):
            exe.run(prog, feed={"x": _x(2)}, fetch_list=[loss],
                    scope=pt.Scope())
        exe.run(startup)
        main.global_block().ops.append(OpDesc(
            "while", {"X": [loss], "Condition": [loss]}, {"Out": [loss]}))
        with pytest.raises(NotImplementedError, match="'while'"):
            exe.run(pt.CompiledProgram(main), feed={"x": _x(2)},
                    fetch_list=[loss])


# ---------------------------------------------------------------------------
# capture-safe constants
# ---------------------------------------------------------------------------

def _grid():
    """A dense grid of floats over 2^-30..2^30 and its negatives, the
    constants of gelu and dropout, and the int8 scales: 2^(b-1)-1 and its
    square for 2 to 16 bits."""
    mags = np.geomspace(2.0 ** -30, 2.0 ** 30, 20001)
    consts = [np.sqrt(2 / np.pi), np.sqrt(0.5), 1.0, 0.0]
    consts += [1.0 - p for p in np.linspace(0.0, 0.99, 100)]
    bnds = [float(2 ** (b - 1) - 1) for b in range(2, 17)]
    return [float(v) for v in np.concatenate(
        [mags, -mags, consts, bnds, [b * b for b in bnds]])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_full_gives_the_bits_of_tensor(dtype):
    grid = _grid()
    old = torch.stack([torch.tensor(v, dtype=dtype) for v in grid])
    new = torch.stack([torch.full((), v, dtype=dtype) for v in grid])
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[old.element_size()]
    assert torch.equal(old.view(ints), new.view(ints))


def test_the_sites_take_full():
    """gelu, dropout's keep, the int8 division and accuracy's count give
    the bits they gave with torch.tensor constants."""
    from paddle_tpu_torch.ops import basic, metrics, quant

    x = torch.from_numpy(np.random.RandomState(3).randn(4096).astype(
        np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        for approximate, c in ((False, np.sqrt(0.5)),
                               (True, np.sqrt(2 / np.pi))):
            got = basic.gelu_fn(xd, approximate)
            cc = torch.tensor(c, dtype=dtype)
            want = xd * (0.5 * (1.0 + torch.tanh(
                cc * (xd + 0.044715 * xd ** 3)))) if approximate \
                else 0.5 * xd * torch.special.erfc(-xd * cc)
            assert torch.equal(got, want)
        for bits in range(2, 9):
            b = float(2 ** (bits - 1) - 1)
            for v in (b, b * b):
                assert torch.equal(quant._div(xd, v),
                                   xd / torch.tensor(v, dtype=dtype))
        attrs = get_op_def("dropout").canonical_attrs(
            {"dropout_prob": 0.3, "is_test": True})
        out = basic.dropout({"X": xd}, attrs, "cpu")
        assert torch.equal(out["Out"], xd * torch.tensor(0.7, dtype=dtype))
    idx = torch.arange(10).reshape(5, 2)
    acc = metrics.accuracy({"Out": idx.float(), "Indices": idx,
                            "Label": torch.arange(5).reshape(5, 1) * 2},
                           {}, "cpu")
    assert acc["Total"].dtype == torch.int64 and int(acc["Total"]) == 5
