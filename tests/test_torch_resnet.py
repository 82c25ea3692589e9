"""The port's ResNet training slice against the JAX package.

The bench's two ResNet-50 training legs (``bench.py``
``_build_resnet50_train`` with ``s2d=False``): ``resnet50(is_test=False)``,
then ``fuse_conv_bn_train`` (leg ``conv_bn_stats``) or no chain fused under
the ``conv_epilogue`` flag (leg ``conv_epilogue``), ``nhwc_transpile``, and
``decorate(Momentum(0.1, 0.9), init_loss_scaling=1.0,
use_dynamic_loss_scaling=False).minimize(loss)``.

- Programs: at full width (224x224, 1000 classes) the port builds the JAX
  package's main and startup programs, ``to_dict`` equal: 53
  ``conv2d_bn_train`` ops (or 53 ``conv2d`` and ``batch_norm``), 55
  ``cast``s, 54 ``uniform_random`` and 376 ``fill_constant`` startup ops.
- Training both ways, on a small ResNet of the same blocks (stem, max
  pool, a stride-2 and an identity bottleneck, average pool, fc; 32x32,
  batch 2, 10 classes): 3 steps from the same weights, a program built
  by either package run by the other's Executor.  The port runs the JAX
  package's conv_bn_stats program under flag ``interpret`` (both compute
  the kernels' functions; the JAX side runs its Pallas interpreter, with
  each interpreted call compiled once per shape, and that run is made
  once for the file) and its conv_epilogue program under ``off``; the JAX package runs the port's programs of both
  legs under ``off`` (the composite), with AMP and in f32.  After step 1
  every var of the two scopes has the same dtype and shape (int64 is
  int32 in JAX without x64), and the loss falls.  Under AMP the
  activations are bf16, so torch and XLA part by a bf16 step (2^-8
  relative) at each rounding, and batch-2 batch norm amplifies that in
  the grads: losses agree within rtol=1e-2, each grad within 0.1 of its
  norm (measured: 0.04), and the change of all parameters, velocities and
  BN running statistics over the 3 steps within 0.3 of its norm
  (measured: 0.18).  In f32 they agree within rtol=1e-5 in the loss,
  1e-4 of each grad's scale and 1e-5 abs in every persistable (measured:
  ~1e-6 relative).
- The BN running statistics are persistables that ``convert`` carries by
  name: the port's own build trains from the JAX run's starting values.
"""

from __future__ import annotations

import contextlib
import importlib
import json
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.contrib.mixed_precision import decorate as jax_decorate
from paddle_tpu.core.program import Program as JaxProgram
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.core.scope import scope_guard as jax_scope_guard
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.transpiler import fuse_conv_bn_train as jax_fuse_conv_bn
from paddle_tpu.transpiler import fuse_conv_epilogue as jax_fuse_conv_ep
from paddle_tpu.transpiler import nhwc_transpile as jax_nhwc
from torch_port_helpers import fresh_port_programs, to_numpy

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core.program import Program as PortProgram

# (``paddle_tpu.models`` binds the name ``resnet`` to the function)
jax_resnet = importlib.import_module("paddle_tpu.models.resnet")
jax_pallas_conv = importlib.import_module("paddle_tpu.ops.pallas_conv")
port_resnet = importlib.import_module("paddle_tpu_torch.models.resnet")
STEPS = 3
LEGS = ("conv_bn_stats", "conv_epilogue")


def _pkg(which):
    """(package, resnet module, fuse pass by leg, nhwc pass, decorate)."""
    if which == "jax":
        return (fluid, jax_resnet, {"conv_bn_stats": jax_fuse_conv_bn,
                                    "conv_epilogue": jax_fuse_conv_ep},
                jax_nhwc, jax_decorate)
    return (pt, port_resnet,
            {"conv_bn_stats": pt.transpiler.fuse_conv_bn_train,
             "conv_epilogue": pt.transpiler.fuse_conv_epilogue},
            pt.transpiler.nhwc_transpile,
            pt.contrib.mixed_precision.decorate)


def _small_resnet(pkg, mod):
    layers = pkg.layers
    image = layers.data("image", shape=[3, 32, 32], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    x = mod._conv_bn(image, 8, 7, stride=2, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    x = mod._bottleneck(x, 4, 2)
    x = mod._bottleneck(x, 4, 1)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    logits = layers.fc(pool, size=10)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return {"logits": logits, "loss": loss, "acc": acc}


def _build(which, leg, full=False, amp=True):
    """The bench's sequence in the default programs; returns (model,
    chains fused)."""
    pkg, mod, fuse, nhwc, decorate = _pkg(which)
    model = mod.resnet50(is_test=False) if full else _small_resnet(pkg, mod)
    main = pkg.default_main_program()
    fused = fuse[leg](main, protected=[model[k].name
                                       for k in ("loss", "logits", "acc")])
    nhwc(main)
    opt = pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    if amp:
        opt = decorate(opt, init_loss_scaling=1.0,
                       use_dynamic_loss_scaling=False)
    opt.minimize(model["loss"])
    return model, fused


def _canon(program):
    return json.dumps(program.to_dict(), sort_keys=True)


@contextlib.contextmanager
def leg_flag(leg, mode):
    try:
        jax_set_flags({leg: mode})
        pt.set_flags({leg: mode})
        yield
    finally:
        jax_set_flags({leg: "off"})
        pt.set_flags({leg: "off"})


# ---------------------------------------------------------------------------
# (a) the same programs at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leg", LEGS)
def test_port_builds_the_jax_resnet50_train_program(leg):
    from conftest import _reset_program_state

    _reset_program_state()
    _, j_fused = _build("jax", leg, full=True)
    jmain, jstart = fluid.default_main_program(), \
        fluid.default_startup_program()
    with fresh_port_programs():
        _, p_fused = _build("port", leg, full=True)
        pmain, pstart = pt.default_main_program(), \
            pt.default_startup_program()
        assert _canon(pmain) == _canon(jmain)
        assert _canon(pstart) == _canon(jstart)
        types = Counter(op.type for op in pmain.global_block().ops)
        start_types = Counter(op.type for op in pstart.global_block().ops)
    assert p_fused == j_fused == (53 if leg == "conv_bn_stats" else 0)
    assert types["cast"] == 55 and types["momentum"] == 161
    assert types["transpose"] == 2
    if leg == "conv_bn_stats":
        assert sum(types.values()) == 414
        assert types["conv2d_bn_train"] == types["conv2d_bn_train_grad"] \
            == 53 and "batch_norm" not in types
    else:
        assert sum(types.values()) == 650
        assert types["conv2d"] == types["batch_norm"] == \
            types["batch_norm_grad"] == 53
    assert (start_types["uniform_random"], start_types["fill_constant"]) \
        == (54, 376)


# ---------------------------------------------------------------------------
# (b) the small ResNet trained both ways
# ---------------------------------------------------------------------------

def _batch():
    rng = np.random.RandomState(5)
    return {"image": rng.rand(2, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}


def _persistable_names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _grad_names(main):
    return sorted(v.name + "@GRAD" for v in main.all_parameters())


def _dtypes(scope_vars, name_of):
    """{var: (dtype, shape)} of every tensor in a scope; int64 reads as
    int32, as JAX holds it without x64."""
    out = {}
    for name, v in scope_vars.items():
        t = v.get()
        if not hasattr(t, "dtype"):
            continue
        dt = name_of(t.dtype)
        out[name] = ("int32" if dt == "int64" else dt, tuple(t.shape))
    return out


def _train_jax(main, startup, loss_name, init=None):
    """Startup (or ``init`` values), then STEPS steps: the losses, the
    first step's grads and dtypes, the persistables before and after."""
    exe = fluid.Executor(fluid.CPUPlace())
    with jax_scope_guard(JaxScope()):
        np.random.seed(0)
        exe.run(startup)
        scope = fluid.global_scope()
        if init is not None:
            for name, arr in init.items():
                scope.var(name).set(jnp.asarray(arr))
        names = _persistable_names(main)
        start = {n: to_numpy(scope.find_var(n).get()) for n in names}
        losses, grads, dtypes = [], None, None
        for _ in range(STEPS):
            out = exe.run(main, feed=_batch(),
                          fetch_list=[loss_name] + _grad_names(main))
            losses.append(float(out[0]))
            if grads is None:
                grads = dict(zip(_grad_names(main), out[1:]))
                dtypes = _dtypes(scope.vars, str)
        end = {n: to_numpy(scope.find_var(n).get()) for n in names}
    return losses, grads, start, end, dtypes


def _train_port(main, startup, loss_name, init=None):
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    if init is None:
        np.random.seed(0)
        exe.run(startup, scope=scope)
    else:
        convert.params_from_numpy(init, scope, "cpu")
    names = _persistable_names(main)
    start = convert.params_to_numpy(scope, names)
    losses, grads, dtypes = [], None, None
    for _ in range(STEPS):
        out = exe.run(main, feed=_batch(), scope=scope,
                      fetch_list=[loss_name] + _grad_names(main))
        losses.append(float(out[0]))
        if grads is None:
            grads = dict(zip(_grad_names(main), out[1:]))
            dtypes = _dtypes(scope.vars,
                             lambda d: str(d).replace("torch.", ""))
    leaked = [n for n, v in scope.vars.items()
              if isinstance(v.get(), torch.Tensor)
              and (v.get().requires_grad or v.get().grad_fn is not None)]
    assert leaked == []
    return losses, grads, start, convert.params_to_numpy(scope, names), \
        dtypes


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)),
                                               1e-30)


def _assert_same_training(got, want, amp):
    p_losses, p_grads, p_start, p_end, p_dt = got
    j_losses, j_grads, j_start, j_end, j_dt = want
    assert p_dt == j_dt
    assert ("bfloat16" in {d for d, _ in p_dt.values()}) == amp
    assert np.isfinite(p_losses).all() and p_losses[-1] < p_losses[0]
    np.testing.assert_allclose(p_losses, j_losses,
                               rtol=1e-2 if amp else 1e-5)
    assert sorted(p_grads) == sorted(j_grads)
    for name, j in j_grads.items():
        p, j = p_grads[name].astype(np.float32), j.astype(np.float32)
        if amp:
            assert _rel_norm(p, j) <= 0.1, name
        else:
            np.testing.assert_allclose(p, j, rtol=0, atol=1e-4 * float(
                np.abs(j).max()), err_msg=name)
    assert sorted(p_end) == sorted(j_end)
    assert [n for n in j_end if n.startswith("batch_norm")
            and n.endswith(("w_1", "w_2"))]        # the running stats
    for name in j_end:
        np.testing.assert_array_equal(p_start[name], j_start[name])
        if not amp:
            np.testing.assert_allclose(p_end[name], j_end[name], rtol=0,
                                       atol=1e-5, err_msg=name)
    if amp:
        # the three steps' change of every persistable together
        diff = sum(float(np.sum(np.square(
            p_end[n].astype(np.float32) - j_end[n].astype(np.float32))))
            for n in j_end)
        change = sum(float(np.sum(np.square(
            j_end[n].astype(np.float32) - j_start[n].astype(np.float32))))
            for n in j_end)
        assert diff <= 0.3 ** 2 * change


def _static(v):
    """Nested lists as nested tuples: a hashable static argument."""
    return tuple(map(_static, v)) if isinstance(v, (list, tuple)) else v


@contextlib.contextmanager
def _jax_conv_kernels_jitted():
    """The JAX package's conv_stats and bn_apply Pallas calls, each under
    one ``jax.jit``.  Called eagerly, an interpreted ``pallas_call``
    traces and compiles its kernel again at every call (0.2-3 s each
    here); jitted, each shape compiles once, to the same computation, so
    the run's numbers are the same (its losses are bit-equal)."""
    conv_stats = jax.jit(jax_pallas_conv._conv_stats_pallas,
                         static_argnums=(3, 4, 5))
    bn_apply = jax.jit(jax_pallas_conv._bn_apply_pallas,
                       static_argnums=(6, 7))

    def conv_stats_once(x, w, bias, strides, padding, interpret=False):
        return conv_stats(x, w, bias, _static(strides), _static(padding),
                          interpret)

    def bn_apply_once(y, mean, rstd, scale, shift, residual, act,
                      interpret=False):
        return bn_apply(y, mean, rstd, scale, shift, residual, act,
                        interpret)

    with mock.patch.multiple(jax_pallas_conv,
                             _conv_stats_pallas=conv_stats_once,
                             _bn_apply_pallas=bn_apply_once):
        yield


_JAX_RUNS = {}


def _jax_built_run(leg, mode, amp):
    """The small ResNet built and trained by the JAX package under the
    leg's flag ``mode``: (loss name, main dict, startup dict, run).  Kept
    for the file's other tests: the Pallas interpreter takes ~8 s a
    step."""
    key = (leg, mode, amp)
    if key not in _JAX_RUNS:
        from conftest import _reset_program_state

        _reset_program_state()
        model, _ = _build("jax", leg, amp=amp)
        jmain, jstart = fluid.default_main_program(), \
            fluid.default_startup_program()
        with leg_flag(leg, mode), _jax_conv_kernels_jitted():
            run = _train_jax(jmain, jstart, model["loss"].name)
        _JAX_RUNS[key] = (model["loss"].name, jmain.to_dict(),
                          jstart.to_dict(), run)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("leg,mode", [("conv_bn_stats", "interpret"),
                                      ("conv_epilogue", "off")])
def test_port_executor_trains_a_jax_built_resnet(leg, mode):
    """conv_bn_stats under ``interpret``: both compute the two kernels'
    functions (the JAX package's Pallas kernels under their
    interpreter); conv_epilogue under ``off``: both run the plain conv
    and the unfused batch norm with its hand-written grad."""
    loss, main, startup, want = _jax_built_run(leg, mode, amp=True)
    with leg_flag(leg, mode):
        got = _train_port(PortProgram.from_dict(main),
                          PortProgram.from_dict(startup), loss)
    _assert_same_training(got, want, amp=True)


@pytest.mark.parametrize("amp", [True, False], ids=["amp", "f32"])
@pytest.mark.parametrize("leg", LEGS)
def test_jax_executor_trains_a_port_built_resnet(leg, amp):
    """Flag ``off``: both run the composite (the unfused conv + batch
    norm inside ``conv2d_bn_train``; the plain conv for ``conv2d``)."""
    with fresh_port_programs():
        model, _ = _build("port", leg, amp=amp)
        pmain, pstart = pt.default_main_program(), \
            pt.default_startup_program()
        with leg_flag(leg, "off"):
            got = _train_port(pmain, pstart, model["loss"].name)
            want = _train_jax(JaxProgram.from_dict(pmain.to_dict()),
                              JaxProgram.from_dict(pstart.to_dict()),
                              model["loss"].name)
    _assert_same_training(got, want, amp)


def test_port_front_end_trains_from_jax_weights():
    """The port's own build, with the JAX run's starting parameters and
    BN running statistics carried in by name."""
    _, _, _, want = _jax_built_run("conv_bn_stats", "interpret", amp=True)
    with fresh_port_programs():
        model, _ = _build("port", "conv_bn_stats")
        pmain = pt.default_main_program()
        assert _persistable_names(pmain) == sorted(want[2])
        with leg_flag("conv_bn_stats", "interpret"):
            got = _train_port(pmain, pt.default_startup_program(),
                              model["loss"].name, init=want[2])
    _assert_same_training(got, want, amp=True)
