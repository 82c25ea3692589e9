"""The port's AMP training slice against the JAX package.

The bench's training configuration of the LM at test widths (2 layers,
d64, 4 heads, vocab 512, seq 64): ``transpiler.fuse_epilogue(anchors=
("fc",))``, then ``contrib.mixed_precision.decorate(Adam(lr, fuse=True),
init_loss_scaling=1.0, use_dynamic_loss_scaling=False).minimize(loss)``.
The same numpy inputs go to both packages.

- Ops: ``cast``, ``elementwise_mul``, ``gelu``,
  ``check_finite_and_unscale``, ``update_loss_scaling`` and
  ``fused_adam`` against the JAX ops, with the same slots, attrs and
  ``in_place`` maps: f32 within atol=rtol=1e-6 (1e-5 for gelu, whose erf
  and tanh are other implementations), bf16 within one bf16 step
  (rtol=8e-3), and equal output dtypes.
- Programs: the port appends the JAX package's ops, slots, var names,
  attrs and roles (``to_dict`` equal), with static and dynamic scaling.
- Training both ways: 3 steps from the same weights, a program built by
  either package run by the other's Executor, with the ``fc_epilogue``
  flag ``interpret`` (both compute the kernel's function) and ``off``
  (both run the chain).  After step 1 every var in the two scopes has
  the same dtype and shape (int64 feeds are int32 in JAX without x64).
  The products, the bias adds of the chain and the activations run in
  bf16, so torch and XLA part by a bf16 step (2^-8 relative) at each
  rounding: losses agree within rtol=1e-3, each grad within 3e-2 of its
  largest magnitude, parameters within ``2*lr`` a step (Adam's step is
  about ``lr*sign(m1)``, and a grad near 0 may flip) plus 1e-3.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.contrib.mixed_precision import decorate as jax_decorate
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core.program import Program as JaxProgram
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.core.scope import scope_guard as jax_scope_guard
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.models.transformer import \
    transformer_encoder_model as jax_model
from paddle_tpu.transpiler import fuse_epilogue as jax_fuse_epilogue
from torch_port_helpers import TINY_LM, fresh_port_programs, to_numpy

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core.program import Program as PortProgram
from paddle_tpu_torch.models.transformer import \
    transformer_encoder_model as port_model

TRAIN_LM = dict(TINY_LM, is_test=False)
LR = 1e-3
STEPS = 3
LOSS_RTOL = 1e-3
GRAD_TOL = 3e-2
PARAM_ATOL = 2 * LR * STEPS + 1e-3
_rng = np.random.RandomState(8)


def _f(*shape):
    return _rng.standard_normal(shape).astype(np.float32)


def _bf16(a):
    return np.asarray(a, np.float32).astype(jnp.bfloat16)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@contextlib.contextmanager
def fc_flag(mode):
    """Sets the fc_epilogue flag of both packages; restores ``off``."""
    try:
        jax_set_flags({"fc_epilogue": mode})
        pt.set_flags({"fc_epilogue": mode})
        yield
    finally:
        jax_set_flags({"fc_epilogue": "off"})
        pt.set_flags({"fc_epilogue": "off"})


# ---------------------------------------------------------------------------
# (a) the slice's new ops
# ---------------------------------------------------------------------------

_P32, _P16 = _f(4, 5), _bf16(_f(3, 2))
_inf_grad = _f(2, 3)
_inf_grad[1, 2] = np.inf
_nan_grad = _bf16(_f(4))
_nan_grad[0] = np.nan

# (op type, inputs, attrs); list inputs are duplicable slots
OP_CASES = [
    ("cast", {"X": _f(3, 4)}, {"out_dtype": "bfloat16"}),
    ("cast", {"X": _bf16(_f(3, 4))}, {"out_dtype": "float32"}),
    ("cast", {"X": np.arange(6, dtype=np.int32)}, {"out_dtype": "float32"}),
    ("elementwise_mul", {"X": _f(2, 3, 4), "Y": _f(2, 3, 4)}, {}),
    ("elementwise_mul", {"X": _f(2, 3, 4), "Y": _f(3)}, {"axis": 1}),
    ("elementwise_mul", {"X": np.float32(2.5) * np.ones((), np.float32),
                         "Y": np.array([0.5], np.float32)}, {}),
    ("elementwise_mul", {"X": _bf16(_f(2, 4)), "Y": _bf16(_f(4))}, {}),
    # a 0-d f32 operand promotes bf16 to f32, as jnp does (torch alone
    # would keep bf16)
    ("elementwise_mul", {"X": _bf16(_f(2, 4)), "Y": np.float32(1.5)}, {}),
    ("gelu", {"X": _f(3, 7) * 3}, {}),
    ("gelu", {"X": _f(3, 7) * 3}, {"approximate": True}),
    ("gelu", {"X": _bf16(_f(3, 7) * 3)}, {}),
    ("gelu", {"X": _bf16(_f(3, 7) * 3)}, {"approximate": True}),
    ("check_finite_and_unscale",
     {"X": [_f(2, 3), _bf16(_f(4))], "Scale": np.array([4.0], np.float32)},
     {}),
    ("check_finite_and_unscale",
     {"X": [_inf_grad, _bf16(_f(4))], "Scale": np.array([8.0], np.float32)},
     {}),
    ("check_finite_and_unscale",
     {"X": [_f(2, 3), _nan_grad], "Scale": np.array([2.0], np.float32)},
     {"zero_on_inf": False}),
    ("update_loss_scaling",
     {"FoundInfinite": np.array([False]),
      "PrevLossScaling": np.array([1024.0], np.float32),
      "InGoodSteps": np.array([999], np.int32),
      "InBadSteps": np.array([1], np.int32)}, {}),
    ("update_loss_scaling",
     {"FoundInfinite": np.array([True]),
      "PrevLossScaling": np.array([1024.0], np.float32),
      "InGoodSteps": np.array([5], np.int32),
      "InBadSteps": np.array([1], np.int32)}, {}),
    ("update_loss_scaling",
     {"FoundInfinite": np.array([True]),
      "PrevLossScaling": np.array([1.1], np.float32),
      "InGoodSteps": np.array([0], np.int32),
      "InBadSteps": np.array([0], np.int32)},
     {"decr_every_n_nan_or_inf": 1, "decr_ratio": 0.5}),
    ("update_loss_scaling",
     {"FoundInfinite": np.array([False]),
      "PrevLossScaling": np.array([8.0], np.float32),
      "InGoodSteps": np.array([1], np.int32),
      "InBadSteps": np.array([0], np.int32)},
     {"incr_every_n_steps": 3, "incr_ratio": 4.0}),
    ("fused_adam",
     {"Param": [_P32, _P16, _f(7)], "Grad": [_f(4, 5), _bf16(_f(3, 2)),
                                             _f(7)],
      "Moment1": [_f(4, 5), _bf16(_f(3, 2)), np.zeros(7, np.float32)],
      "Moment2": [np.abs(_f(4, 5)), _bf16(np.abs(_f(3, 2))),
                  np.zeros(7, np.float32)],
      "Beta1Pow": np.array([0.9 ** 3], np.float32),
      "Beta2Pow": np.array([0.999 ** 3], np.float32),
      "LearningRate": np.array([1e-3], np.float32)}, {}),
    ("fused_adam",
     {"Param": [_f(3, 3)], "Grad": [_f(3, 3)],
      "Moment1": [np.zeros((3, 3), np.float32)],
      "Moment2": [np.zeros((3, 3), np.float32)],
      "Beta1Pow": np.array([0.8], np.float32),
      "Beta2Pow": np.array([0.99], np.float32),
      "LearningRate": np.array([1e-2], np.float32)},
     {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6}),
]


def _tree(x, fn):
    return [fn(v) for v in x] if isinstance(x, list) else fn(x)


@pytest.mark.parametrize("op_type,ins,attrs", OP_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(OP_CASES)])
def test_op_matches_jax(op_type, ins, attrs):
    jdef = jax_registry.get_op_def(op_type)
    pdef = pt_registry.get_op_def(op_type)
    assert (pdef.inputs, pdef.outputs, pdef.duplicable, pdef.optional,
            pdef.differentiable, pdef.in_place) == \
        (jdef.inputs, jdef.outputs, jdef.duplicable, jdef.optional,
         jdef.differentiable, jdef.in_place)
    assert {k: repr(v) for k, v in pdef.attrs.items()} == \
        {k: repr(v) for k, v in jdef.attrs.items()}
    jout = jdef.compute({k: _tree(v, jnp.asarray) for k, v in ins.items()},
                        jdef.canonical_attrs(attrs))
    pout = pdef.compute({k: _tree(v, _to_torch) for k, v in ins.items()},
                        pdef.canonical_attrs(attrs), torch.device("cpu"))
    assert set(pout) == set(jout)
    for slot in jout:
        p_list, j_list = pout[slot], jout[slot]
        if not isinstance(p_list, list):
            p_list, j_list = [p_list], [j_list]
        assert len(p_list) == len(j_list), slot
        for p, j in zip(p_list, j_list):
            assert str(p.dtype).replace("torch.", "") == str(j.dtype) \
                and tuple(p.shape) == tuple(j.shape), slot
            bf16 = p.dtype == torch.bfloat16
            tol = 8e-3 if bf16 else 1e-5 if op_type == "gelu" else 1e-6
            np.testing.assert_allclose(to_numpy(p), to_numpy(j), rtol=tol,
                                       atol=tol, err_msg=slot)


def test_amp_layers_append_the_jax_ops():
    from conftest import _reset_program_state

    def build(layers):
        x = layers.data("x", shape=[6], dtype="float32")
        h = layers.cast(layers.relu(x), "bfloat16")
        h = layers.gelu(layers.cast(h, "float32"), approximate=True)
        return layers.elementwise_mul(h, x)

    _reset_program_state()
    build(fluid.layers)
    want = fluid.default_main_program().to_dict()
    with fresh_port_programs():
        build(pt.layers)
        assert pt.default_main_program().to_dict() == want


# ---------------------------------------------------------------------------
# (b) the same program
# ---------------------------------------------------------------------------

def _canon(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _minimize(pkg, fuse_epilogue, decorate, model, dynamic):
    """The bench's sequence: fuse the fc chains, then minimize with
    Adam(fuse=True) under AMP."""
    fuse_epilogue(pkg.default_main_program(), protected=[model["loss"].name],
                  anchors=("fc",))
    opt = decorate(pkg.optimizer.Adam(LR, fuse=True), init_loss_scaling=1.0,
                   use_dynamic_loss_scaling=dynamic)
    opt.minimize(model["loss"])


def _build_jax(dynamic=False):
    model = jax_model(**TRAIN_LM)
    _minimize(fluid, jax_fuse_epilogue, jax_decorate, model, dynamic)
    return (model, fluid.default_main_program(),
            fluid.default_startup_program())


def _build_port(dynamic=False):
    model = port_model(**TRAIN_LM)
    _minimize(pt, pt.transpiler.fuse_epilogue,
              pt.contrib.mixed_precision.decorate, model, dynamic)
    return model, pt.default_main_program(), pt.default_startup_program()


@pytest.mark.parametrize("dynamic", [False, True])
def test_port_appends_the_jax_amp_train_program(dynamic):
    from conftest import _reset_program_state

    _reset_program_state()
    _, jmain, jstart = _build_jax(dynamic)
    with fresh_port_programs():
        _, pmain, pstart = _build_port(dynamic)
        assert _canon(pmain) == _canon(jmain)
        assert _canon(pstart) == _canon(jstart)
        types = [op.type for op in pmain.global_block().ops]
    n = TRAIN_LM["n_layer"]
    assert types.count("fc_epilogue") == 3 * n
    assert types.count("fc_epilogue_grad") == 3 * n
    assert types.count("fused_adam") == 1 and "adam" not in types
    assert types.count("update_loss_scaling") == int(dynamic)
    assert types.count("check_finite_and_unscale") == 1


def test_decorated_optimizer_refuses_grad_clip():
    with fresh_port_programs():
        model = port_model(**TRAIN_LM)
        opt = pt.contrib.mixed_precision.decorate(pt.optimizer.Adam(LR))
        with pytest.raises(NotImplementedError, match="grad_clip"):
            opt.minimize(model["loss"], grad_clip=lambda pg: pg)


# ---------------------------------------------------------------------------
# (c) the slice both ways
# ---------------------------------------------------------------------------

def _batch():
    rng = np.random.RandomState(6)
    shape = (2, TRAIN_LM["max_len"], 1)
    return {n: rng.randint(0, TRAIN_LM["vocab_size"], shape).astype(np.int64)
            for n in ("src_ids", "tgt_label")}


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


def _train_jax(main, startup, loss_name):
    exe = fluid.Executor(fluid.CPUPlace())
    with jax_scope_guard(JaxScope()):
        np.random.seed(0)
        exe.run(startup)
        scope = fluid.global_scope()
        losses, grads, dtypes = [], None, None
        for _ in range(STEPS):
            out = exe.run(main, feed=_batch(),
                          fetch_list=[loss_name] + _grad_names(main))
            losses.append(float(out[0]))
            if grads is None:
                grads = dict(zip(_grad_names(main), out[1:]))
                dtypes = _dtypes(scope.vars, str)
        end = {n: to_numpy(scope.find_var(n).get())
               for n in _persistable_names(main)}
    return losses, grads, end, dtypes


def _train_port(main, startup, loss_name):
    from paddle_tpu_torch import convert

    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    np.random.seed(0)
    exe.run(startup, scope=scope)
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
    end = convert.params_to_numpy(scope, _persistable_names(main))
    return losses, grads, end, dtypes


def _assert_same_training(got, want):
    (p_losses, p_grads, p_end, p_dt), (j_losses, j_grads, j_end, j_dt) = \
        got, want
    assert p_dt == j_dt
    assert "bfloat16" in {d for d, _ in p_dt.values()}
    assert np.isfinite(p_losses).all() and p_losses[-1] < p_losses[0]
    np.testing.assert_allclose(p_losses, j_losses, rtol=LOSS_RTOL)
    assert sorted(p_grads) == sorted(j_grads)
    for name in j_grads:
        scale = float(np.abs(j_grads[name]).max())
        np.testing.assert_allclose(p_grads[name], j_grads[name], rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)
    assert sorted(p_end) == sorted(j_end)
    for name in j_end:
        np.testing.assert_allclose(p_end[name].astype(np.float32),
                                   j_end[name].astype(np.float32), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_port_executor_trains_a_jax_built_amp_program():
    """Flag ``interpret``: both compute the fc_epilogue kernel's function
    (the JAX package's Pallas kernel under its interpreter)."""
    from conftest import _reset_program_state

    _reset_program_state()
    model, jmain, jstart = _build_jax()
    with fc_flag("interpret"):
        want = _train_jax(jmain, jstart, model["loss"].name)
        got = _train_port(PortProgram.from_dict(jmain.to_dict()),
                          PortProgram.from_dict(jstart.to_dict()),
                          model["loss"].name)
    _assert_same_training(got, want)


def test_jax_executor_trains_a_port_built_amp_program():
    """Flag ``off``: both run the unfused chain inside the fused op."""
    with fresh_port_programs():
        model, pmain, pstart = _build_port()
        with fc_flag("off"):
            got = _train_port(pmain, pstart, model["loss"].name)
            want = _train_jax(JaxProgram.from_dict(pmain.to_dict()),
                              JaxProgram.from_dict(pstart.to_dict()),
                              model["loss"].name)
    _assert_same_training(got, want)
