"""The quantisation ops (``paddle_tpu_torch/ops/quant.py``) against the
JAX package's, and the s8 kernel's operand contract.

The same numpy inputs go through both registries' computes.

- Every one of the 14 op types, slots, attrs, defaults and flags equal,
  outputs ``array_equal``: both packages run the same f32 (and bf16) ops
  in the same order, each rounded to nearest, and the s8 products are
  exact integer sums in both (XLA's int32 dot; the port's f64 im2col
  product of the int8 operands, rounded).
- ``conv2d_int8`` and ``mul_int8``: the int32 accumulators (out_dtype
  ``int32``) and every epilogue subset (bias and residual in f32 and
  bf16, relu, OutScale, f32 and bf16 out, an int8 input, the dynamic
  scale), NCHW and NHWC, groups, strides, dilations, the 3-channel stem,
  every ``mul_int8`` scale convention: ``array_equal``.  The same errors
  (an int8 input without InScale; per-row scales in the interlayer
  modes) in both.
- The kernel's operands (``_x_operand``, ``_filter_operand``: each
  group's channels padded to 16 with zeros, OHWI filters kept per
  parameter; the packed stem's ``_stem_x_operand`` and
  ``_stem_filter_operand``: 4 channels, even width padding, a filter
  row's taps in rows of 16 bytes) give the plain version's accumulator through the kernel's
  own tap loop in numpy int64, and the copies are counted; the route
  each convolution takes follows its groups and channels.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX ops)
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.flags import set_flags as jax_set_flags
from torch_port_helpers import to_numpy

import paddle_tpu_torch as pt  # noqa: F401  (registers the port's ops)
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.ops import quant as Q

_rng = np.random.RandomState(21)


def _f(*shape, scale=1.0):
    return (_rng.standard_normal(shape) * scale).astype(np.float32)


def _i8(*shape):
    return _rng.randint(-127, 128, shape).astype(np.int8)


def _pos(*shape, lo=0.5, hi=2.0):
    return _rng.uniform(lo, hi, shape).astype(np.float32)


def _bf16(a):
    return np.asarray(a, np.float32).astype(jnp.bfloat16)


def _to_torch(v):
    if isinstance(v, list):
        return [_to_torch(x) for x in v]
    if str(v.dtype) == "bfloat16":
        return torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(v))


def _to_jax(v):
    if isinstance(v, list):
        return [_to_jax(x) for x in v]
    return jnp.asarray(v)


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _run_both(op_type, ins, attrs):
    jdef = jax_registry.get_op_def(op_type)
    pdef = pt_registry.get_op_def(op_type)
    jout = jdef.compute({k: _to_jax(v) for k, v in ins.items()},
                        jdef.canonical_attrs(attrs))
    pout = pdef.compute({k: _to_torch(v) for k, v in ins.items()},
                        pdef.canonical_attrs(attrs), torch.device("cpu"))
    return jout, pout


def _assert_equal_outputs(jout, pout):
    assert set(pout) == set(jout)
    for slot, j in jout.items():
        p = pout[slot]
        assert _dtype_name(p) == str(j.dtype) and \
            tuple(p.shape) == tuple(j.shape), (slot, p.dtype, j.dtype,
                                               p.shape, j.shape)
        np.testing.assert_array_equal(to_numpy(p), to_numpy(j),
                                      err_msg=slot)


_x = _f(3, 4, 5)
_w = _f(6, 3, 3, 3, scale=0.2)
OP_CASES = [
    ("fake_quantize_abs_max", {"X": _x}, {}),
    ("fake_quantize_abs_max", {"X": _x}, {"bit_length": 4}),
    ("fake_channel_wise_quantize_abs_max", {"X": _w}, {}),
    ("fake_channel_wise_quantize_abs_max", {"X": _w}, {"quant_axis": 1}),
    ("fake_quantize_moving_average_abs_max",
     {"X": _x, "InScale": _pos(1), "InState": _pos(1), "InAccum": _pos(1)},
     {}),
    ("fake_quantize_moving_average_abs_max",
     {"X": _x, "InScale": _pos(1)}, {"moving_rate": 0.5}),
    ("fake_quantize_moving_average_abs_max",
     {"X": _x, "InScale": _pos(1), "InState": _pos(1), "InAccum": _pos(1)},
     {"is_test": True}),
    ("fake_dequantize_max_abs",
     {"X": _i8(3, 4).astype(np.float32), "Scale": _pos(1)}, {}),
    ("fake_quantize_range_abs_max", {"X": _x, "InScale": _pos(1)}, {}),
    ("fake_quantize_range_abs_max", {"X": _x, "InScale": _pos(1)},
     {"is_test": True, "bit_length": 6}),
    ("fake_channel_wise_dequantize_max_abs",
     {"X": _i8(6, 3, 2, 2).astype(np.float32),
      "Scales": [_pos(6), _pos(1)]}, {"quant_bits": [8, 8]}),
    ("fake_channel_wise_dequantize_max_abs",
     {"X": _i8(3, 6).astype(np.float32), "Scales": [_pos(6)]},
     {"quant_axis": 1}),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"X": _x, "InScale": _pos(1), "InAccum": _pos(1), "InState": _pos(1)},
     {}),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"X": _x, "InScale": _pos(1)}, {}),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"X": _x, "InScale": _pos(1), "InAccum": _pos(1), "InState": _pos(1)},
     {"is_test": True}),
    ("moving_average_abs_max_scale",
     {"X": _x, "InAccum": _pos(1), "InState": _pos(1)}, {}),
    ("moving_average_abs_max_scale", {"X": np.zeros((3, 4), np.float32)},
     {}),
    ("quantize", {"Input": _f(3, 5)}, {"Scale": 40.0}),
    ("quantize", {"Input": np.abs(_f(3, 5))},
     {"Scale": 60.0, "is_negative_input": False}),
    ("dequantize", {"Input": _i8(3, 5)}, {"Scale": 12.5}),
    ("requantize", {"Input": _i8(2, 3, 4, 4)},
     {"Scale_in": 3.0, "Scale_out": 2.0}),
    ("requantize",
     {"Input": _rng.randint(-200000, 200000, (2, 3, 3, 8)).astype(np.int32),
      "InScale": _pos(1), "FilterScale": _pos(8, 1, 1, 1, lo=0.01, hi=0.1),
      "Bias": _f(8), "OutScale": _pos(1, lo=5.0, hi=10.0)},
     {"fuse_relu": True, "data_format": "NHWC", "ref_dtype": "bfloat16"}),
    ("requantize",
     {"Input": _rng.randint(-200000, 200000, (2, 8, 3, 3)).astype(np.int32),
      "InScale": _pos(1), "FilterScale": _pos(8, lo=0.01, hi=0.1),
      "Bias": _f(8), "OutScale": _pos(1, lo=5.0, hi=10.0)},
     {"bias_axis": 1}),
    ("dequantize_weight", {"X": _i8(6, 3, 3, 3), "Scale": _pos(6, 1, 1, 1)},
     {}),
]


@pytest.mark.parametrize("op_type,ins,attrs", OP_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(OP_CASES)])
def test_quant_op_matches_jax(op_type, ins, attrs):
    jdef = jax_registry.get_op_def(op_type)
    pdef = pt_registry.get_op_def(op_type)
    assert (pdef.inputs, pdef.outputs, pdef.duplicable, pdef.optional,
            pdef.differentiable, pdef.in_place) == \
        (jdef.inputs, jdef.outputs, jdef.duplicable, jdef.optional,
         jdef.differentiable, jdef.in_place)
    assert {k: repr(v) for k, v in pdef.attrs.items()} == \
        {k: repr(v) for k, v in jdef.attrs.items()}
    _assert_equal_outputs(*_run_both(op_type, ins, attrs))


def test_every_quant_op_type_is_ported():
    """The 14 op types of the JAX package's ops/quant.py."""
    import paddle_tpu.ops.quant as jq

    src = open(jq.__file__).read()
    types = sorted(set(
        line.split('"')[1] for line in src.splitlines()
        if line.startswith("@register_op(")))
    assert len(types) == 14
    assert all(pt_registry.has_op_def(t) for t in types)
    assert {c[0] for c in OP_CASES} | {"conv2d_int8", "mul_int8"} == \
        set(types)


@pytest.mark.parametrize("op_type", ["fake_quantize_abs_max",
                                     "fake_quantize_dequantize_moving_"
                                     "average_abs_max"])
def test_fake_quant_straight_through_grad_matches_jax(op_type):
    """The straight-through estimator: X@GRAD is Out@GRAD in both."""
    ins = {"X": _x, "Out@GRAD": _f(*_x.shape)}
    if op_type != "fake_quantize_abs_max":
        ins["InScale"] = _pos(1)
    _assert_equal_outputs(*_run_both(op_type + "_grad", ins, {}))


# ---------------------------------------------------------------------------
# conv2d_int8 and mul_int8
# ---------------------------------------------------------------------------

def _conv_ins(n, h, w, cin, cout, k, groups=1, fmt="NHWC", int8_in=False,
              in_scale=True):
    x = _i8(n, h, w, cin) if int8_in else _f(n, h, w, cin, scale=2.0)
    if fmt == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    ins = {"Input": x, "Filter": _i8(cout, cin // groups, k, k),
           "FilterScale": _pos(cout, 1, 1, 1, lo=0.005, hi=0.02)}
    if in_scale:
        ins["InScale"] = _pos(1, lo=3.0, hi=6.0)
    return ins


def _out_shape(ins, fmt, attrs, k):
    x = ins["Input"]
    n, h, w = (x.shape[0], x.shape[1], x.shape[2]) if fmt == "NHWC" else \
        (x.shape[0], x.shape[2], x.shape[3])
    cout = ins["Filter"].shape[0]
    s, p, d = (attrs.get(a, [1, 1])[0] for a in ("strides", "paddings",
                                                 "dilations"))
    if "paddings" not in attrs:
        p = 0
    oh = (h + 2 * p - (k - 1) * d - 1) // s + 1
    ow = (w + 2 * p - (k - 1) * d - 1) // s + 1
    return (n, oh, ow, cout) if fmt == "NHWC" else (n, cout, oh, ow)


# (name, input kwargs, attrs, epilogue operands)
CONV_CASES = [
    ("int32", dict(n=2, h=9, w=9, cin=24, cout=16, k=3),
     {"paddings": [1, 1], "out_dtype": "int32"}, ()),
    ("f32", dict(n=2, h=9, w=9, cin=24, cout=16, k=3),
     {"paddings": [1, 1]}, ()),
    ("bf16_bias_relu", dict(n=2, h=8, w=8, cin=32, cout=20, k=1), {
        "out_dtype": "bfloat16", "fuse_relu": True}, ("bias",)),
    ("bf16_bias_bf16", dict(n=2, h=8, w=8, cin=32, cout=20, k=1), {
        "out_dtype": "bfloat16"}, ("bias_bf16",)),
    ("bf16_bias_res_relu_outscale", dict(n=2, h=7, w=7, cin=16, cout=24,
                                         k=3),
     {"paddings": [1, 1], "out_dtype": "bfloat16", "fuse_relu": True},
     ("bias", "residual", "outscale")),
    # (the JAX package's conv2d_int8 reaches its Residual stage only
    # after a Bias stage: without Bias it raises UnboundLocalError)
    ("f32_res_bf16", dict(n=2, h=7, w=7, cin=16, cout=24, k=3),
     {"paddings": [1, 1]}, ("bias", "residual_bf16")),
    ("bf16_res_bf16_relu", dict(n=2, h=7, w=7, cin=16, cout=24, k=3),
     {"paddings": [1, 1], "out_dtype": "bfloat16", "fuse_relu": True},
     ("bias_bf16", "residual_bf16")),
    ("int8_in_outscale", dict(n=2, h=6, w=6, cin=48, cout=32, k=3,
                              int8_in=True),
     {"paddings": [1, 1], "out_dtype": "bfloat16", "fuse_relu": True},
     ("bias", "outscale")),
    ("dynamic_scale", dict(n=2, h=6, w=6, cin=8, cout=8, k=3,
                           in_scale=False), {"paddings": [1, 1]}, ()),
    ("stride2_dilation2", dict(n=2, h=13, w=11, cin=20, cout=12, k=3),
     {"strides": [2, 2], "paddings": [2, 2], "dilations": [2, 2],
      "out_dtype": "bfloat16"}, ("bias",)),
    ("groups2", dict(n=2, h=7, w=7, cin=24, cout=10, k=3, groups=2),
     {"paddings": [1, 1], "groups": 2}, ("bias", "outscale")),
    ("groups2_int32", dict(n=2, h=7, w=7, cin=24, cout=10, k=3, groups=2),
     {"paddings": [1, 1], "groups": 2, "out_dtype": "int32"}, ()),
    ("stem", dict(n=2, h=20, w=20, cin=3, cout=16, k=7),
     {"strides": [2, 2], "paddings": [3, 3], "out_dtype": "bfloat16"},
     ("bias",)),
    ("nchw", dict(n=2, h=8, w=8, cin=16, cout=8, k=3, fmt="NCHW"),
     {"paddings": [1, 1], "data_format": "NCHW", "bias_axis": 1,
      "out_dtype": "bfloat16", "fuse_relu": True},
     ("bias", "residual")),
]


def _add_operands(ins, fmt, shape, operands):
    cout = ins["Filter"].shape[0]
    for name in operands:
        if name.startswith("bias"):
            b = _f(cout)
            ins["Bias"] = _bf16(b) if name.endswith("bf16") else b
        elif name.startswith("residual"):
            r = _f(*shape)
            ins["Residual"] = _bf16(r) if name.endswith("bf16") else r
        elif name == "outscale":
            ins["OutScale"] = _pos(1, lo=2.0, hi=4.0)


@pytest.mark.parametrize("name,kw,attrs,operands", CONV_CASES,
                         ids=[c[0] for c in CONV_CASES])
def test_conv2d_int8_matches_jax(name, kw, attrs, operands):
    fmt = kw.get("fmt", "NHWC")
    attrs = {"data_format": fmt, **attrs}
    ins = _conv_ins(**kw)
    _add_operands(ins, fmt, _out_shape(ins, fmt, attrs, kw["k"]), operands)
    jout, pout = _run_both("conv2d_int8", ins, attrs)
    _assert_equal_outputs(jout, pout)


@pytest.mark.parametrize("algo", ["conv", "im2col"])
def test_conv2d_int8_both_algos_give_the_jax_bits(algo):
    """Both values of flag int8_conv_algo give the same bits in the JAX
    package; the port computes one function for both."""
    ins = _conv_ins(n=2, h=8, w=8, cin=16, cout=16, k=3)
    attrs = {"data_format": "NHWC", "paddings": [1, 1],
             "out_dtype": "int32", "groups": 1}
    jax_set_flags({"int8_conv_algo": algo})
    pt.set_flags({"int8_conv_algo": algo})
    try:
        _assert_equal_outputs(*_run_both("conv2d_int8", ins, attrs))
    finally:
        jax_set_flags({"int8_conv_algo": "conv"})
        pt.set_flags({"int8_conv_algo": "conv"})


def _mul_ins(x_shape, k, n, scale_shape, int8_in=False, in_scale=True):
    x = _i8(*x_shape) if int8_in else _f(*x_shape, scale=2.0)
    ins = {"X": x, "Y": _i8(k, n),
           "Scale": _pos(*scale_shape, lo=0.005, hi=0.02)}
    if in_scale:
        ins["InScale"] = _pos(1, lo=3.0, hi=6.0)
    return ins


# (name, x shape, K, N, scale shape, attrs, operands)
MUL_CASES = [
    ("per_tensor_int32", (4, 12), 12, 10, (1,), {"out_dtype": "int32"},
     (), {}),
    ("per_tensor", (4, 12), 12, 10, (1,), {}, (), {}),
    ("per_col", (4, 12), 12, 10, (1, 10), {"out_dtype": "bfloat16"},
     ("bias",), {}),
    ("per_col_1d", (4, 12), 12, 10, (10,), {"fuse_relu": True}, ("bias",),
     {}),
    ("per_row", (4, 12), 12, 10, (12, 1), {"out_dtype": "bfloat16"}, (),
     {}),
    ("per_row_1d_square", (4, 10), 10, 10, (10,), {}, (), {}),
    ("per_row_dynamic", (4, 12), 12, 10, (12, 1), {}, (),
     {"in_scale": False}),
    ("flatten_4d", (2, 3, 2, 2), 12, 10, (1, 10), {"out_dtype": "bfloat16",
                                                   "fuse_relu": True},
     ("bias", "outscale"), {}),
    ("int8_in", (4, 12), 12, 10, (1, 10), {"out_dtype": "bfloat16"},
     ("outscale",), {"int8_in": True}),
    ("dynamic", (5, 12), 12, 10, (1,), {}, (), {"in_scale": False}),
]


@pytest.mark.parametrize("name,x_shape,k,n,scale_shape,attrs,operands,kw",
                         MUL_CASES, ids=[c[0] for c in MUL_CASES])
def test_mul_int8_matches_jax(name, x_shape, k, n, scale_shape, attrs,
                              operands, kw):
    ins = _mul_ins(x_shape, k, n, scale_shape, **kw)
    for op in operands:
        if op == "bias":
            ins["Bias"] = _f(n)
        else:
            ins["OutScale"] = _pos(1, lo=2.0, hi=4.0)
    _assert_equal_outputs(*_run_both("mul_int8", ins, attrs))


def test_int8_ops_raise_as_the_jax_package_does():
    """An int8 input without InScale; per-row weight scales with an int8
    input or an int32 out."""
    ins = _conv_ins(n=1, h=4, w=4, cin=16, cout=8, k=1, int8_in=True,
                    in_scale=False)
    cases = [("conv2d_int8", ins, {"data_format": "NHWC"}),
             ("mul_int8", _mul_ins((2, 12), 12, 10, (1,), int8_in=True,
                                   in_scale=False), {}),
             ("mul_int8", _mul_ins((2, 12), 12, 10, (12, 1)),
              {"out_dtype": "int32"}),
             ("mul_int8", _mul_ins((2, 12), 12, 10, (12, 1), int8_in=True),
              {})]
    for op_type, ins, attrs in cases:
        msgs = []
        for run in (lambda: jax_registry.get_op_def(op_type).compute(
                        {k: _to_jax(v) for k, v in ins.items()},
                        jax_registry.get_op_def(op_type)
                        .canonical_attrs(attrs)),
                    lambda: pt_registry.get_op_def(op_type).compute(
                        {k: _to_torch(v) for k, v in ins.items()},
                        pt_registry.get_op_def(op_type)
                        .canonical_attrs(attrs), torch.device("cpu"))):
            with pytest.raises(ValueError) as e:
                run()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the kernel's operand contract
# ---------------------------------------------------------------------------

def _kernel_tap_loop(xk, wk, groups, strides, pads, dils, oh, ow):
    """The kernel's sum in numpy int64: for each group and filter tap,
    the [M, cig] patch of the padded x against w[:, kh, kw, :] of the
    group's output channels, zero outside the image."""
    n, h, w, c = xk.shape
    cout, kh_, kw_, cig = wk.shape
    cog = cout // groups
    (sh, sw), (ph, pw), (dh, dw) = strides, pads, dils
    x64 = xk.astype(np.int64)
    acc = np.zeros((n, oh, ow, cout), np.int64)
    for g in range(groups):
        for kh in range(kh_):
            for kw in range(kw_):
                ih = np.arange(oh) * sh - ph + kh * dh
                iw = np.arange(ow) * sw - pw + kw * dw
                mh, mw = (ih >= 0) & (ih < h), (iw >= 0) & (iw < w)
                patch = np.zeros((n, oh, ow, cig), np.int64)
                sub = x64[:, ih[mh]][:, :, iw[mw]][..., g * cig:(g + 1) * cig]
                patch[:, np.where(mh)[0][:, None], np.where(mw)[0]] = sub
                acc[..., g * cog:(g + 1) * cog] += patch @ wk[
                    g * cog:(g + 1) * cog, kh, kw, :].astype(np.int64).T
    return acc


@pytest.mark.parametrize("cin,cout,k,groups,s,p,d", [
    (3, 16, 7, 1, 2, 3, 1), (24, 20, 3, 1, 1, 1, 1), (32, 8, 1, 1, 2, 0, 1),
    (24, 10, 3, 2, 1, 2, 2), (40, 12, 3, 4, 2, 1, 1)])
def test_kernel_operands_give_the_plain_accumulator(cin, cout, k, groups, s,
                                                    p, d):
    x8 = torch.from_numpy(_i8(2, 11, 9, cin))
    w = torch.from_numpy(_i8(cout, cin // groups, k, k))
    copies = Q.conv_int8.copies
    xk = Q._x_operand(x8, groups)
    cig = cin // groups
    padded = cig % 16 != 0
    assert Q.conv_int8.copies == copies + int(padded)
    assert xk.shape[3] == groups * (-(-cig // 16) * 16)
    wk = Q._filter_operand(w, None)
    assert wk.is_contiguous() and wk.shape == (cout, k, k, xk.shape[3] //
                                                groups)
    assert Q._filter_operand(w, None) is wk   # kept per parameter
    acc = Q._conv_acc_plain(x8, w, (s, s), (p, p), (d, d), groups)
    got = _kernel_tap_loop(xk.numpy(), wk.numpy(), groups, (s, s), (p, p),
                           (d, d), acc.shape[1], acc.shape[2])
    np.testing.assert_array_equal(got, acc.numpy().astype(np.int64))


def _stem_tap_loop(xs, ws, strides, pads, dils, oh, ow):
    """The packed stem's sum in numpy int64: for each filter row kh and
    byte b of its KP bytes, tap b // 4 of channel b % 4 of x [N,H,W,4]
    against w[:, kh, b], zero outside the image and past the taps."""
    n, h, w, _ = xs.shape
    cout, kh_, kp = ws.shape
    (sh, sw), (ph, pw), (dh, _) = strides, pads, dils
    x64 = xs.astype(np.int64)
    acc = np.zeros((n, oh, ow, cout), np.int64)
    for kh in range(kh_):
        ih = np.arange(oh) * sh - ph + kh * dh
        for b in range(kp):
            tap, c = divmod(b, 4)
            iw = np.arange(ow) * sw - pw + tap
            mh, mw = (ih >= 0) & (ih < h), (iw >= 0) & (iw < w)
            col = np.zeros((n, oh, ow), np.int64)
            col[:, np.where(mh)[0][:, None], np.where(mw)[0]] = \
                x64[:, ih[mh]][:, :, iw[mw], c]
            acc += col[..., None] * ws[:, kh, b].astype(np.int64)
    return acc


@pytest.mark.parametrize("cin,cout,k,s,p,dh,w", [
    (3, 16, 7, 2, 3, 1, 9), (1, 8, 3, 2, 1, 1, 10), (4, 12, 5, 2, 2, 2, 9),
    (2, 8, 1, 2, 0, 1, 11)])
def test_stem_operands_give_the_plain_accumulator(cin, cout, k, s, p, dh, w):
    """The packed stem (groups 1, at most 4 channels, dw 1, an even width
    stride): x padded to 4 channels and to an even width padding and
    width (so the kernel's pairs of taps lie on 8 bytes), the filter as
    [Cout, KH, KP] rows of KW taps of 4 channels (KP: KW * 4 rounded up
    to 16), K = KH * KP; the kernel's sum over those operands, at the
    padding the wrapper hands it, is the plain version's accumulator."""
    x8 = torch.from_numpy(_i8(2, 11, w, cin))
    wt = torch.from_numpy(_i8(cout, cin, k, k))
    assert Q.kernel_route(cin, 1, (s, s), (dh, 1)) == "wgmma_stem"
    copies = Q.conv_int8.copies
    xs, pw = Q._stem_x_operand(x8, p)
    assert Q.conv_int8.copies == copies + 1
    assert xs.shape[:2] == (2, 11) and xs.shape[3] == 4 and xs.is_contiguous()
    assert xs.shape[2] % 2 == 0 and pw % 2 == 0 and pw == p - p % 2
    ws = Q._stem_filter_operand(wt, None)
    kp = -(-k * 4 // 16) * 16
    assert ws.shape == (cout, k, kp) and ws.is_contiguous()
    assert Q._stem_filter_operand(wt, None) is ws   # kept per parameter
    assert Q._filter_operand(wt, None) is not ws    # apart from OHWI
    acc = Q._conv_acc_plain(x8, wt, (s, s), (p, p), (dh, 1), 1)
    got = _stem_tap_loop(xs.numpy(), ws.numpy(), (s, s), (p, pw), (dh, 1),
                         acc.shape[1], acc.shape[2])
    np.testing.assert_array_equal(got, acc.numpy().astype(np.int64))


def test_kernel_route_follows_groups_and_channels():
    """One group takes the wgmma kernel (a stem of at most 4 channels with
    unit width dilation and an even width stride packed); grouped
    convolutions the mma.sync one."""
    assert Q.kernel_route(64, 1, (1, 1), (1, 1)) == "wgmma"
    assert Q.kernel_route(3, 1, (2, 2), (1, 1)) == "wgmma_stem"
    assert Q.kernel_route(3, 1, (2, 2), (1, 2)) == "wgmma"
    assert Q.kernel_route(3, 1, (1, 1), (1, 1)) == "wgmma"
    assert Q.kernel_route(20, 1, (1, 1), (2, 2)) == "wgmma"
    assert Q.kernel_route(12, 2, (1, 1), (1, 1)) == "mma_sync"
    assert set(Q.conv_int8.launches_by_route) == {"wgmma", "wgmma_stem",
                                                  "mma_sync"}


def test_conv_int8_takes_the_plain_version_on_the_cpu():
    """The wrapper's dispatch: a CPU or meta tensor runs conv_int8_plain
    and launches nothing."""
    x8 = torch.from_numpy(_i8(1, 4, 4, 16))
    w = torch.from_numpy(_i8(8, 16, 1, 1))
    alpha = torch.tensor(0.01)
    launches = Q.conv_int8.launches
    y = Q.conv_int8(x8, w, alpha, out_dtype=torch.int32)
    assert Q.conv_int8.launches == launches and y.dtype == torch.int32
    assert torch.equal(y, Q.conv_int8_plain(x8, w, alpha,
                                            out_dtype=torch.int32))
    ym = Q.conv_int8(x8.to("meta"), w.to("meta"), alpha.to("meta"),
                     colscale=torch.ones(8, device="meta"),
                     out_dtype=torch.bfloat16)
    assert Q.conv_int8.launches == launches
    assert ym.device.type == "meta" and ym.shape == (1, 4, 4, 8)
    assert ym.dtype == torch.bfloat16
