"""The ResNet slice's ops and conv functions against the JAX package.

The same numpy inputs go through ``paddle_tpu`` and ``paddle_tpu_torch``:

- Ops (registry compute, slots, attrs and flags equal): ``conv2d``,
  ``pool2d``, ``batch_norm`` (with the moments guard's two-pass branch),
  the hand-written ``batch_norm_grad``, ``transpose``, ``softmax``,
  ``top_k`` (ties: the lower index first) and ``accuracy``.  f32 within
  atol=rtol=1e-5 (torch and XLA sum in other orders); a bf16 output
  within one bf16 step (8e-3); layout moves and integer outputs equal.
  The ints are int64 in the port and int32 in JAX without x64.
- The max-pool gradient routes a tied window to its first maximum in
  both, in NCHW and NHWC, with all-zero windows after a ReLU: equal.
- The three conv kernels' plain versions (``conv_epilogue_plain``,
  ``conv_stats_plain``, ``bn_apply_plain``) against the Pallas kernels
  under their interpreter, over ``tests/test_pallas_conv.py``'s cases plus
  a 3-channel 7x7/2 stem: f32 within 1e-5 of the output's scale (other
  summation orders), bf16 within one bf16 step of it.
- ``conv2d_epilogue`` and ``conv2d_bn_act`` (the autograd Functions)
  against ``jax.vjp`` of the JAX entry points, for the kernel path and
  the composite, with pre-activations that are exactly 0 (gradient 0
  there in both) and cotangents on the batch statistics: 1e-5 of scale.
- The IR ops ``conv2d_epilogue`` and ``conv2d_bn_train`` and the flag
  dispatch of NHWC ``conv2d``, under each flag value both packages know.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX ops)
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.ops import pallas_conv as jpc
from paddle_tpu.ops.nn import _moments_1pass as jax_moments
from torch_port_helpers import to_numpy

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.ops import conv_epilogue as cep
from paddle_tpu_torch.ops.nn import _moments_1pass as pt_moments

_rng = np.random.RandomState(11)


def _f(*shape, scale=1.0):
    return (_rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16(a):
    return np.asarray(a, np.float32).astype(jnp.bfloat16)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _dtype_name(t):
    """A result's dtype as JAX names it without x64."""
    name = str(t.dtype).replace("torch.", "")
    return {"int64": "int32", "float64": "float32"}.get(name, name)


@contextlib.contextmanager
def both_flags(**flags):
    """Sets flags of both packages; restores their defaults."""
    defaults = {"conv_epilogue": "off", "conv_bn_stats": "off",
                "maxpool_grad_algo": "sas"}
    try:
        jax_set_flags(flags)
        pt.set_flags(flags)
        yield
    finally:
        reset = {k: defaults[k] for k in flags}
        jax_set_flags(reset)
        pt.set_flags(reset)


# ---------------------------------------------------------------------------
# (a) the ops
# ---------------------------------------------------------------------------

def _bn_ins(x, c):
    return {"X": x, "Scale": _f(c) + 1.0, "Bias": _f(c),
            "Mean": _f(c), "Variance": np.abs(_f(c)) + 0.5}


# the moments guard: |mean| >> std with a probe slice of exact zeros, so
# the shifted one-pass variance cancels and the two-pass branch runs
_guard_x = (np.full((4, 2, 5, 5), 1000.0, np.float32)
            + _f(4, 2, 5, 5, scale=1e-2))
_guard_x[:, :, 0, 0] = 0.0

_NCHW, _NHWC = {"data_format": "NCHW"}, {"data_format": "NHWC"}

# (op type, inputs, attrs); every input is a numpy array
OP_CASES = [
    ("conv2d", {"Input": _f(2, 4, 7, 7), "Filter": _f(6, 4, 3, 3)},
     {"strides": [1, 1], "paddings": [1, 1]}),
    ("conv2d", {"Input": _f(2, 3, 16, 16), "Filter": _f(8, 3, 7, 7)},
     {"strides": [2, 2], "paddings": [3, 3]}),
    ("conv2d", {"Input": _f(2, 8, 8, 4), "Filter": _f(6, 4, 1, 1)},
     {"strides": [2, 2], **_NHWC}),
    ("conv2d", {"Input": _f(1, 9, 7, 8), "Filter": _f(5, 8, 3, 3)},
     {"strides": [2, 2], "paddings": [1, 1], **_NHWC}),
    ("conv2d", {"Input": _f(1, 4, 6, 6), "Filter": _f(6, 2, 3, 3)},
     {"groups": 2, "paddings": [1, 1]}),
    ("pool2d", {"X": _f(2, 3, 9, 9)},
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1]}),
    ("pool2d", {"X": _f(2, 9, 9, 3)},
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], **_NHWC}),
    ("pool2d", {"X": _f(2, 3, 7, 7)},
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "exclusive": True}),
    ("pool2d", {"X": _f(2, 7, 7, 3)},
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "exclusive": False, **_NHWC}),
    ("pool2d", {"X": _f(2, 5, 5, 4)},
     {"pooling_type": "avg", "ksize": [1, 1], "global_pooling": True,
      **_NHWC}),
    ("pool2d", {"X": _f(2, 4, 5, 5)},
     {"pooling_type": "max", "ksize": [1, 1], "global_pooling": True}),
    ("pool2d", {"X": _f(2, 3, 6, 6)},
     {"pooling_type": "avg", "ksize": [2, 3], "adaptive": True}),
    ("pool2d", {"X": _f(2, 6, 6, 3)},
     {"pooling_type": "max", "ksize": [3, 2], "adaptive": True, **_NHWC}),
    ("batch_norm", _bn_ins(_f(2, 3, 4, 5, scale=2.0) + 1.0, 3), {}),
    ("batch_norm", _bn_ins(_f(2, 4, 5, 3), 3),
     {"data_layout": "NHWC", "momentum": 0.8, "epsilon": 1e-3}),
    ("batch_norm", _bn_ins(_f(6, 5), 5), {}),
    ("batch_norm", _bn_ins(_f(2, 3, 4, 4), 3), {"is_test": True}),
    ("batch_norm", _bn_ins(_f(2, 3, 4, 4), 3), {"use_global_stats": True}),
    ("batch_norm", dict(_bn_ins(_f(2, 3, 4, 4), 3), BatchMean=_f(3),
                        BatchVariance=np.abs(_f(3)) + 0.1), {}),
    ("batch_norm", _bn_ins(_guard_x, 2), {}),
    ("batch_norm", _bn_ins(_bf16(_f(2, 4, 4, 3)), 3),
     {"data_layout": "NHWC"}),
    ("batch_norm_grad", {**_bn_ins(_f(2, 3, 4, 5) * 2, 3),
                         "Y@GRAD": _f(2, 3, 4, 5)}, {}),
    ("batch_norm_grad", {**_bn_ins(_f(2, 4, 5, 3), 3),
                         "Y@GRAD": _f(2, 4, 5, 3)},
     {"data_layout": "NHWC", "epsilon": 1e-3}),
    ("batch_norm_grad", {**_bn_ins(_f(2, 3, 4, 4), 3),
                         "Y@GRAD": _f(2, 3, 4, 4)},
     {"use_global_stats": True}),
    ("batch_norm_grad", {**_bn_ins(_f(2, 3, 4, 4), 3),
                         "BatchMean": _f(3),
                         "BatchVariance": np.abs(_f(3)) + 0.1,
                         "Y@GRAD": _f(2, 3, 4, 4)}, {}),
    ("batch_norm_grad", {**_bn_ins(_guard_x, 2),
                         "Y@GRAD": _f(4, 2, 5, 5)}, {}),
    ("transpose", {"X": _f(2, 3, 4, 5)}, {"axis": [0, 2, 3, 1]}),
    ("transpose", {"X": _f(2, 4, 5, 3)}, {"axis": [0, 3, 1, 2]}),
    ("softmax", {"X": _f(3, 7) * 3}, {}),
    ("softmax", {"X": _f(2, 3, 4)}, {"axis": 1}),
    ("top_k", {"X": np.array([[1, 3, 3, 0, 3, 2], [5, 5, 5, 5, 5, 5],
                              [0, -1, 2, 2, 7, 7], [4, 1, 4, 1, 0, 4]],
                             np.float32)}, {"k": 3}),
    ("top_k", {"X": _f(5, 10)}, {"k": 1}),
    ("accuracy", {"Out": _f(4, 2), "Indices": np.array(
        [[3, 1], [0, 2], [5, 4], [1, 1]], np.int64),
        "Label": np.array([[1], [2], [0], [1]], np.int64)}, {}),
]


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
    jout = jdef.compute({k: jnp.asarray(v) for k, v in ins.items()},
                        jdef.canonical_attrs(attrs))
    pout = pdef.compute({k: _to_torch(v) for k, v in ins.items()},
                        pdef.canonical_attrs(attrs), torch.device("cpu"))
    assert set(pout) == set(jout)
    for slot, j in jout.items():
        p = pout[slot]
        assert _dtype_name(p) == str(j.dtype) and \
            tuple(p.shape) == tuple(j.shape), slot
        if not p.is_floating_point() or op_type == "transpose":
            np.testing.assert_array_equal(to_numpy(p), np.asarray(j),
                                          err_msg=slot)
            continue
        tol = 8e-3 if p.dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(to_numpy(p), to_numpy(j), rtol=tol,
                                   atol=tol, err_msg=slot)


def test_moments_guard_takes_the_two_pass_branch():
    """The guard case's variance is the exact two-pass one (the shifted
    one-pass form collapses there), term for term the JAX helper's."""
    axes = (0, 2, 3)
    mean, var = pt_moments(torch.from_numpy(_guard_x), axes)
    j_mean, j_var = jax_moments(jnp.asarray(_guard_x), axes)
    ref = np.var(_guard_x.astype(np.float64), axis=axes)
    np.testing.assert_allclose(var.numpy(), ref, rtol=1e-2)
    np.testing.assert_allclose(var.numpy(), np.asarray(j_var), rtol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=1e-6)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_max_pool_grad_routes_ties_to_the_first_maximum(fmt):
    """After a ReLU whole windows are 0; other windows hold a repeated
    maximum.  Both route each window's cotangent to its first maximum in
    window order (XLA's select_and_scatter with ge), padding excluded."""
    rng = np.random.RandomState(3)
    x = np.maximum(rng.standard_normal((2, 3, 9, 9)), 0).astype(np.float32)
    x[:, :, :4, :4] = 0.0
    x[:, :, 5:8, 5:8] = 1.5
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    attrs = {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1], "data_format": fmt}
    jdef = jax_registry.get_op_def("pool2d")
    pdef = pt_registry.get_op_def("pool2d")
    out, vjp = jax.vjp(lambda a: jdef.compute(
        {"X": a}, jdef.canonical_attrs(attrs))["Out"], jnp.asarray(x))
    g = rng.standard_normal(out.shape).astype(np.float32)
    j_dx, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    p_out = pdef.compute({"X": xt}, pdef.canonical_attrs(attrs),
                         torch.device("cpu"))["Out"]
    p_dx, = torch.autograd.grad(p_out, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(p_out.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(p_dx.numpy(), np.asarray(j_dx))


def test_maxpool_compare_is_not_ported():
    """Named when the port raised on the flag; it now computes the JAX
    package's compare backward (tests/test_torch_maxpool_compare.py
    holds it case by case): on an all-zero input every element of each
    2x2 window takes the window's cotangent, as in the JAX op."""
    pdef = pt_registry.get_op_def("pool2d")
    jdef = jax_registry.get_op_def("pool2d")
    attrs = {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2]}
    g = np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2) + 1
    with both_flags(maxpool_grad_algo="compare"):
        xt = torch.zeros(1, 1, 4, 4, requires_grad=True)
        out = pdef.compute({"X": xt}, pdef.canonical_attrs(attrs),
                           torch.device("cpu"))["Out"]
        p_dx, = torch.autograd.grad(out, xt, torch.from_numpy(g))
        _, vjp = jax.vjp(lambda a: jdef.compute(
            {"X": a}, jdef.canonical_attrs(attrs))["Out"],
            jnp.zeros((1, 1, 4, 4), jnp.float32))
        j_dx, = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(p_dx.numpy(), np.asarray(j_dx))
    np.testing.assert_array_equal(
        p_dx.numpy()[0, 0], np.kron(g[0, 0], np.ones((2, 2), np.float32)))


# ---------------------------------------------------------------------------
# (b) the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

# tests/test_pallas_conv.py's _CASES, plus the 3-channel 7x7/2 stem:
# (n, h, w, cin, cout, k, stride, pad, bias, residual, act)
CONV_CASES = [
    (2, 8, 8, 16, 32, 3, 1, 1, True, True, "relu"),
    (1, 9, 9, 8, 16, 3, 2, 1, False, True, None),
    (2, 8, 8, 16, 32, 1, 1, 0, True, False, "relu"),
    (1, 7, 7, 8, 24, 1, 2, 0, False, False, None),
    (1, 10, 6, 8, 16, 3, 1, 0, True, True, "relu"),
    (1, 8, 8, 8, 300, 1, 1, 0, False, True, None),
    (1, 11, 11, 3, 16, 7, 2, 3, True, True, "relu"),
]


def _conv_case(case, dtype, seed=0):
    n, h, w, cin, cout, k, s, p, has_b, has_r, act = case
    rng = np.random.RandomState(seed)
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    arrs = [rng.standard_normal((n, h, w, cin)),
            rng.standard_normal((cout, cin, k, k)) * (k * k * cin) ** -0.5,
            rng.standard_normal(cout) if has_b else None,
            rng.standard_normal((n, oh, ow, cout)) if has_r else None]
    arrs = [None if a is None else a.astype(np.float32) for a in arrs]
    if dtype == "bfloat16":
        arrs = [None if a is None else _bf16(a) for a in arrs]
    return arrs, (s, s), ((p, p), (p, p)), act or ""


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else _to_torch(a)


def _assert_close(got, want, dtype):
    """f32 within 1e-5 of the reference's scale; bf16 within one bf16
    step of it (the two may round f32 sums taken in other orders to
    neighbouring values)."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[f"case{i}" for i in range(len(CONV_CASES))])
def test_conv_plain_versions_match_the_pallas_kernels(case, dtype):
    (x, w, b, r), strides, padding, act = _conv_case(case, dtype)
    with jax.default_matmul_precision("float32"):
        want = jpc._conv_ep_pallas(_j(x), _j(w), _j(b), _j(r), strides,
                                   padding, act, interpret=True)
        want_stats = jpc._conv_stats_pallas(_j(x), _j(w), _j(b), strides,
                                            padding, interpret=True)
    got = cep.conv_epilogue_plain(_t(x), _t(w), _t(b), _t(r), strides,
                                  padding, act)
    assert _dtype_name(got) == str(want.dtype)
    _assert_close(got, want, dtype)
    got_stats = cep.conv_stats_plain(_t(x), _t(w), _t(b), strides, padding)
    assert [_dtype_name(t) for t in got_stats] == \
        [str(t.dtype) for t in want_stats]
    _assert_close(got_stats[0], want_stats[0], dtype)
    for g, wnt in zip(got_stats[1:], want_stats[1:]):
        # partial sums of y and y*y over an image's pixels, in f32
        _assert_close(g, wnt, "float32" if dtype == "float32"
                      else "bfloat16")
    m = float(np.prod(got_stats[0].shape[:3]))
    for g, wnt in zip(cep._finalize_stats(*got_stats[1:], m),
                      jpc._finalize_stats(*want_stats[1:], m)):
        _assert_close(g, wnt, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,has_res,act", [
    ((2, 5, 4, 24), True, "relu"), ((2, 5, 4, 24), False, ""),
    ((1, 3, 3, 13), True, ""), ((2, 7, 7, 16), False, "relu")])
def test_bn_apply_plain_matches_the_pallas_kernel(shape, has_res, act,
                                                  dtype):
    rng = np.random.RandomState(sum(shape))
    c = shape[-1]
    y = rng.standard_normal(shape).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32) if has_res else None
    if dtype == "bfloat16":
        y = _bf16(y)
        res = None if res is None else _bf16(res)
    mean, scale, shift = (rng.standard_normal(c).astype(np.float32)
                          for _ in range(3))
    rstd = (1 / np.sqrt(np.abs(rng.standard_normal(c)) + 0.5)).astype(
        np.float32)
    vecs = (mean, rstd, scale, shift)
    want = jpc._bn_apply_pallas(jnp.asarray(y), *map(jnp.asarray, vecs),
                                _j(res), act, interpret=True)
    got = cep.bn_apply_plain(_to_torch(y), *map(torch.from_numpy, vecs),
                             _t(res), act)
    assert _dtype_name(got) == str(want.dtype)
    if dtype == "float32":
        _assert_close(got, want, dtype)
    else:
        # the same rounding points in both: bf16-equal but for a value
        # whose f32 normalisation straddles a rounding boundary
        diff = np.abs(to_numpy(got) - to_numpy(want))
        assert (diff > 0).mean() <= 0.01
        _assert_close(got, want, dtype)


# ---------------------------------------------------------------------------
# (c) the autograd Functions against jax.vjp
# ---------------------------------------------------------------------------

def _grads_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g is not None and tuple(g.shape) == w.shape
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(to_numpy(g), w, rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_conv_epilogue_grads_match_jax_vjp(impl):
    """Image 0 is all zeros with zero bias and residual there, so its
    pre-activations are exactly 0: the saved-output mask gives them
    gradient 0 in both packages."""
    (x, w, b, r), strides, padding, _ = _conv_case(CONV_CASES[1], "float32")
    b = np.zeros(w.shape[0], np.float32)
    x = np.concatenate([np.zeros_like(x), x])
    r = np.concatenate([np.zeros_like(r), r])
    rng = np.random.RandomState(4)
    g = rng.standard_normal(r.shape).astype(np.float32)
    kw = dict(strides=strides, paddings=(1, 1), act="relu", impl=impl)
    out, vjp = jax.vjp(lambda *a: jpc.conv2d_epilogue(*a, **kw),
                       *map(jnp.asarray, (x, w, b, r)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b, r)]
    p_out = cep.conv2d_epilogue(*leaves, **kw)
    assert (p_out[0] == 0).all()
    np.testing.assert_allclose(p_out.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(p_out, leaves, torch.from_numpy(g))
    assert (got[0][0] == 0).all()
    _grads_close(got, want)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_conv_bn_act_grads_match_jax_vjp(impl):
    """Channel 0 has scale 0, shift 0 and a zero residual, so its
    pre-activations are exactly 0 (gradient 0 there); the batch mean and
    variance outputs carry cotangents of their own."""
    (x, w, b, r), strides, padding, _ = _conv_case(CONV_CASES[0], "float32")
    rng = np.random.RandomState(6)
    c = w.shape[0]
    scale = (rng.standard_normal(c) + 1.0).astype(np.float32)
    shift = rng.standard_normal(c).astype(np.float32)
    scale[0] = shift[0] = 0.0
    r[..., 0] = 0.0
    g = rng.standard_normal(r.shape).astype(np.float32)
    g_mean, g_var = (rng.standard_normal(c).astype(np.float32)
                     for _ in range(2))
    kw = dict(strides=strides, paddings=(1, 1), act="relu", epsilon=1e-5,
              impl=impl)
    outs, vjp = jax.vjp(
        lambda x_, w_, s_, t_, b_, r_: jpc.conv2d_bn_act(
            x_, w_, s_, t_, b_, r_, **kw),
        *map(jnp.asarray, (x, w, scale, shift, b, r)))
    want = vjp(tuple(map(jnp.asarray, (g, g_mean, g_var))))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, w, scale, shift, b, r)]
    p_outs = cep.conv2d_bn_act(*leaves, **kw)
    assert (p_outs[0][..., 0] == 0).all()
    for p, j in zip(p_outs, outs):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(p_outs, leaves, tuple(
        map(torch.from_numpy, (g, g_mean, g_var))))
    _grads_close(got, want)


# ---------------------------------------------------------------------------
# (d) the IR ops and the flag dispatch
# ---------------------------------------------------------------------------

def _ir_op_outputs(op_type, ins, attrs):
    jdef = jax_registry.get_op_def(op_type)
    pdef = pt_registry.get_op_def(op_type)
    jout = jdef.compute({k: jnp.asarray(v) for k, v in ins.items()},
                        jdef.canonical_attrs(attrs))
    pout = pdef.compute({k: _to_torch(v) for k, v in ins.items()},
                        pdef.canonical_attrs(attrs), torch.device("cpu"))
    assert set(pout) == set(jout)
    for slot, j in jout.items():
        assert _dtype_name(pout[slot]) == str(j.dtype), slot
        np.testing.assert_allclose(to_numpy(pout[slot]), to_numpy(j),
                                   rtol=1e-5, atol=1e-5, err_msg=slot)


@pytest.mark.parametrize("mode", ["off", "interpret", "xla"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_epilogue_op_matches_jax(fmt, mode):
    x, w = _f(2, 6, 6, 8), _f(16, 8, 3, 3, scale=0.2)
    res = _f(2, 6, 6, 16)
    if fmt == "NCHW":
        x, res = x.transpose(0, 3, 1, 2).copy(), res.transpose(0, 3, 1, 2)
    ins = {"Input": x, "Filter": w, "Bias": _f(16),
           "Residual": np.ascontiguousarray(res)}
    attrs = {"strides": [1, 1], "paddings": [1, 1], "act": "relu",
             "data_format": fmt}
    with both_flags(conv_epilogue=mode):
        _ir_op_outputs("conv2d_epilogue", ins, attrs)


@pytest.mark.parametrize("mode", ["off", "interpret", "xla"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_bn_train_op_matches_jax(fmt, mode):
    x, res = _f(2, 6, 6, 8), _f(2, 3, 3, 16)
    if fmt == "NCHW":
        x = x.transpose(0, 3, 1, 2).copy()
        res = res.transpose(0, 3, 1, 2).copy()
    ins = {"Input": x, "Filter": _f(16, 8, 3, 3, scale=0.2),
           "Scale": _f(16) + 1.0, "BNBias": _f(16), "Mean": _f(16),
           "Variance": np.abs(_f(16)) + 0.5, "Residual": res}
    attrs = {"strides": [2, 2], "paddings": [1, 1], "act": "relu",
             "momentum": 0.8, "data_format": fmt}
    with both_flags(conv_bn_stats=mode):
        _ir_op_outputs("conv2d_bn_train", ins, attrs)


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_nhwc_conv2d_follows_the_conv_epilogue_flag(mode):
    ins = {"Input": _f(2, 9, 9, 3), "Filter": _f(8, 3, 7, 7, scale=0.1)}
    attrs = {"strides": [2, 2], "paddings": [3, 3], **_NHWC}
    with both_flags(conv_epilogue=mode):
        _ir_op_outputs("conv2d", ins, attrs)


# (n, h, w, cin, cout, k, stride, pad, bias, residual, act): CONV_CASES
# (the 3-channel 7x7/2 stem among them) plus Cin 24 (K off the kernel's
# 64-deep step) at stride 2, more than 256 output pixels (several 128-row
# partials, a ragged last one) and two more narrow inputs
KERNEL_CONTRACT_CASES = CONV_CASES + [
    (2, 9, 9, 24, 64, 3, 2, 1, True, True, "relu"),
    (3, 10, 11, 16, 40, 3, 1, 1, True, False, None),
    # narrow inputs: stride 1 (channels padded to 8), and 4 channels with
    # an odd width and KW at stride 2 (column pairs, like the stem's)
    (2, 9, 9, 3, 24, 3, 1, 1, True, True, "relu"),
    (1, 12, 13, 4, 16, 5, 2, 2, True, False, None),
]


def _kernel_contract(x, w, b, r, strides, padding, act):
    """What the CUDA kernel computes, written plainly from the operands
    and geometry as the wrapper hands them to it (``_kernel_operands``: x
    NHWC, in bf16 its channels padded to a multiple of 8 or, for the
    stem, column pairs of 4 channels at half the stride; w ``[Cout, KH,
    KW, Cin]``, read as the K-major ``[Cout, K]``; the top and left
    padding): the im2col matrix of x with k = (kh * KW + kw) * Cin + c,
    times w^T in f32, the stages, one cast.
    Returns (y, s1, s2), the partials one row per ``stats_tile_m()``
    output pixels as the kernel writes them."""
    import torch.nn.functional as F

    n, h, wd, _ = x.shape
    oh, ow = cep._out_spatial(h, wd, w.shape[2], w.shape[3], *strides,
                              padding)
    xk, wk, (sh, sw), (ph0, pw0) = cep._kernel_operands(x, w, strides,
                                                        padding, ow)
    assert xk.shape[3] == wk.shape[3] and wk.shape[0] == w.shape[0]
    if x.dtype == torch.bfloat16:
        assert xk.shape[3] % 8 == 0 and xk.is_contiguous()
    n, h, wd, cin = xk.shape
    cout, kh, kw, _ = wk.shape
    hp, wp = (oh - 1) * sh + kh, (ow - 1) * sw + kw
    xp = F.pad(xk.float(), (0, 0, pw0, max(wp - wd - pw0, 0),
                            ph0, max(hp - h - ph0, 0)))
    cols = torch.stack([xp[:, i:i + (oh - 1) * sh + 1:sh,
                           j:j + (ow - 1) * sw + 1:sw]
                        for i in range(kh) for j in range(kw)], dim=3)
    acc = cols.reshape(n * oh * ow, kh * kw * cin) @ \
        wk.float().reshape(cout, -1).T
    acc = cep.apply_acc_stages(
        acc, bias=b, residual=None if r is None else r.reshape(acc.shape),
        act=act)
    y = acc.to(x.dtype)
    tile = 128
    yf = F.pad(y.float(), (0, 0, 0, -y.shape[0] % tile))
    yf = yf.reshape(-1, tile, cout)
    return (y.reshape(n, oh, ow, cout), yf.sum(dim=1),
            (yf * yf).sum(dim=1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KERNEL_CONTRACT_CASES, ids=[
    f"case{i}" for i in range(len(KERNEL_CONTRACT_CASES))])
def test_kernel_operand_contract_matches_the_plain_versions(case, dtype):
    """The filter layout, the K order and the channel padding that the
    CUDA kernel's gather now walks by increments, held on the CPU: the
    plain im2col product over the operands as the wrapper hands them
    over equals ``conv_epilogue_plain``, and its 128-row partials
    finalise to ``conv_stats_plain``'s mean and var."""
    (x, w, b, r), strides, padding, act = _conv_case(case, dtype)
    x, w, b, r = map(_t, (x, w, b, r))
    y, _, _ = _kernel_contract(x, w, b, r, strides, padding, act)
    _assert_close(y, cep.conv_epilogue_plain(x, w, b, r, strides, padding,
                                             act), dtype)
    y, s1, s2 = _kernel_contract(x, w, b, None, strides, padding, "")
    y_ref, r1, r2 = cep.conv_stats_plain(x, w, b, strides, padding)
    _assert_close(y, y_ref, dtype)
    assert s1.shape == (-(-y[..., 0].numel() // 128), w.shape[0])
    m = float(y[..., 0].numel())
    for got, want in zip(cep._finalize_stats(s1, s2, m),
                         cep._finalize_stats(r1, r2, m)):
        scale = max(1.0, want.abs().max().item())
        tol = 1e-5 if dtype == "float32" else 1e-3
        assert (got - want).abs().max().item() <= tol * scale


def test_kernel_wrappers_take_the_plain_version_on_the_cpu():
    (x, w, b, r), strides, padding, act = _conv_case(CONV_CASES[0],
                                                     "float32")
    x, w, b, r = map(_t, (x, w, b, r))
    counts = (cep.conv_epilogue_kernel.launches,
              cep.conv_stats_kernel.launches, cep.bn_apply_kernel.launches)
    assert torch.equal(
        cep.conv_epilogue_kernel(x, w, b, r, strides, padding, act),
        cep.conv_epilogue_plain(x, w, b, r, strides, padding, act))
    for a, e in zip(cep.conv_stats_kernel(x, w, b, strides, padding),
                    cep.conv_stats_plain(x, w, b, strides, padding)):
        assert torch.equal(a, e)
    vec = torch.ones(w.shape[0])
    y = torch.randn(r.shape)
    assert torch.equal(cep.bn_apply_kernel(y, vec, vec, vec, vec, r, act),
                       cep.bn_apply_plain(y, vec, vec, vec, vec, r, act))
    assert counts == (cep.conv_epilogue_kernel.launches,
                      cep.conv_stats_kernel.launches,
                      cep.bn_apply_kernel.launches)
    with pytest.raises(ValueError, match="CPU"):
        cep.conv2d_epilogue(x, w, impl="pallas")
