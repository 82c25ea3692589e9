"""The op families of ``paddle_tpu/ops/basic.py`` against the port's.

Every op of the elementwise family, ``matmul``, the reduce family, the
activations, ``pow``, ``sigmoid_cross_entropy_with_logits``, ``concat``,
``slice`` and ``one_hot``: the same slots, attr defaults and
differentiability in both registries, then the same numpy inputs through
the JAX op's compute and the port's, forward and (for a differentiable
op) the synthesised grad against ``jax.vjp``'s with the same cotangent.
Each case with a float input runs in f32 and in bf16 (the inputs rounded
to bf16 once, for both packages).

Tolerances: f32 within rtol=atol=1e-5 (torch and XLA sum and evaluate
transcendentals in other orders); bf16 within rtol=atol=1e-2 forward
(one bf16 step, 2^-8 relative, where a transcendental of the two
libraries rounds to the other side) and 2e-2 for grads (two or three
roundings in the chain).  The ops that must be exact are held exactly:
``mod``, ``floordiv``, ``floor``, ``ceil``, ``round``, ``slice``,
``concat``, ``one_hot``, ``reduce_all``/``reduce_any`` and the reduce
max/min, and the gradients' tie rules (``jnp.clip`` and
``jnp.maximum`` give each side of a tie half; ``jnp.where`` keeps its
branch's; ``jnp.abs`` has gradient 1 at 0).  Integer outputs are compared by value: the JAX package runs
without x64, so its int64 inputs compute as int32.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import registry as jax_registry
from torch_port_helpers import to_numpy

from paddle_tpu_torch.core import registry as pt_registry

_rng = np.random.RandomState(15)


def _f(*shape, lo=None, hi=None):
    if lo is not None:
        return _rng.uniform(lo, hi, shape).astype(np.float32)
    return _rng.standard_normal(shape).astype(np.float32)


def _i(*shape, lo=-7, hi=8):
    return _rng.randint(lo, hi, shape).astype(np.int64)


def _nonzero(a):
    return np.where(np.abs(a) < 0.25, np.sign(a) + (a == 0), a) \
        .astype(a.dtype)


_ties = np.array([[-1.0, 0.0, 0.0, 2.0, 6.0, 7.0],
                  [3.0, -0.5, 0.5, 1.0, -3.0, 2.5]], np.float32)

# (op type, inputs, attrs); lists are duplicable slots
BASE_CASES = [
    # the elementwise family
    ("elementwise_add", {"X": _f(2, 3, 4), "Y": _f(3)}, {"axis": 1}),
    ("elementwise_sub", {"X": _f(2, 3, 4), "Y": _f(2, 3, 4)}, {}),
    ("elementwise_sub", {"X": _f(2, 3, 4), "Y": _f(4)}, {}),
    ("elementwise_mul", {"X": _f(2, 3, 4), "Y": _f(1, 3, 4)}, {}),
    ("elementwise_div", {"X": _f(2, 3, 4), "Y": _nonzero(_f(3, 4))}, {}),
    ("elementwise_div", {"X": _f(4, 5), "Y": _nonzero(_f(4))},
     {"axis": 0}),
    ("elementwise_min", {"X": _ties, "Y": np.full((6,), 0.5, np.float32)},
     {}),
    ("elementwise_max", {"X": _ties, "Y": np.full((6,), 0.5, np.float32)},
     {}),
    ("elementwise_max", {"X": _f(2, 3, 4), "Y": _f(3)}, {"axis": 1}),
    ("elementwise_pow", {"X": _f(3, 4, lo=0.2, hi=2.0),
                         "Y": _f(3, 4, lo=-1.5, hi=2.5)}, {}),
    ("elementwise_mod", {"X": _f(3, 5) * 4, "Y": _nonzero(_f(3, 5))}, {}),
    ("elementwise_mod", {"X": _f(4, 6) * 5,
                         "Y": np.array([-2.5, 1.5, -0.75, 3.0, 2.0, -1.0],
                                       np.float32)}, {}),
    ("elementwise_mod", {"X": _i(4, 6, lo=-20, hi=21),
                         "Y": np.array([-3, 4, -5, 7, 2, -1], np.int64)},
     {}),
    ("elementwise_floordiv", {"X": _f(3, 5) * 4, "Y": _nonzero(_f(3, 5))},
     {}),
    ("elementwise_floordiv",
     {"X": _i(4, 6, lo=-20, hi=21),
      "Y": np.array([-3, 4, -5, 7, 2, -1], np.int64)}, {}),
    # matmul
    ("matmul", {"X": _f(3, 4), "Y": _f(4, 5)}, {}),
    ("matmul", {"X": _f(2, 4, 3), "Y": _f(2, 5, 4)},
     {"transpose_X": True, "transpose_Y": True}),
    ("matmul", {"X": _f(2, 3, 6, 4), "Y": _f(2, 3, 5, 4)},
     {"transpose_Y": True, "alpha": 0.37}),
    ("matmul", {"X": _f(2, 6, 6), "Y": _f(2, 6, 5)}, {"alpha": 2.0}),
    ("matmul", {"X": _f(4), "Y": _f(4, 3)}, {}),
    # the reduce family
    ("reduce_sum", {"X": _f(2, 3, 4)}, {}),
    ("reduce_sum", {"X": _f(2, 3, 4)}, {"dim": []}),
    ("reduce_sum", {"X": _f(2, 3, 4)}, {"dim": [1, 2], "keep_dim": True}),
    ("reduce_sum", {"X": _f(2, 3, 4)}, {"dim": [-1]}),
    ("reduce_sum", {"X": _f(2, 3, 4)}, {"dim": [1], "reduce_all": True}),
    ("reduce_mean", {"X": _f(2, 3, 4)}, {"dim": [0, 2]}),
    ("reduce_mean", {"X": _f(2, 3, 4)}, {"reduce_all": True,
                                         "keep_dim": True}),
    ("reduce_max", {"X": _f(2, 3, 4)}, {"dim": [1]}),
    ("reduce_max", {"X": _f(2, 3, 4)}, {"dim": []}),
    ("reduce_min", {"X": _f(2, 3, 4)}, {"dim": [-1, 0], "keep_dim": True}),
    ("reduce_prod", {"X": _f(2, 3, 4, lo=0.5, hi=1.5)}, {"dim": [1]}),
    ("reduce_prod", {"X": _f(2, 3, 4, lo=-1.5, hi=1.5)},
     {"dim": [0, 2], "keep_dim": True}),
    ("reduce_prod", {"X": _f(2, 3, 4, lo=0.5, hi=1.5)},
     {"reduce_all": True}),
    ("reduce_all", {"X": (_f(3, 4) > -1.0)}, {"dim": [1]}),
    ("reduce_all", {"X": np.ones((2, 3), bool)}, {"dim": []}),
    ("reduce_any", {"X": (_f(3, 4) > 1.0)}, {"dim": [0],
                                             "keep_dim": True}),
    ("reduce_any", {"X": np.zeros((2, 3), bool)}, {"reduce_all": True}),
    # pow
    ("pow", {"X": _f(3, 4, lo=0.2, hi=2.0)}, {}),
    ("pow", {"X": _f(3, 4, lo=0.2, hi=2.0)}, {"factor": 2.5}),
    ("pow", {"X": _f(3, 4)}, {"factor": 3}),
    # sigmoid cross entropy (a tie of max(x, 0) at x == 0 in column 1)
    ("sigmoid_cross_entropy_with_logits",
     {"X": _ties, "Label": _f(2, 6, lo=0.0, hi=1.0)}, {}),
    ("sigmoid_cross_entropy_with_logits",
     {"X": _f(4, 3) * 3,
      "Label": np.array([[0, 1, 1], [1, 0, 1], [1, 1, 0], [0, 0, 1]],
                        np.float32)}, {"ignore_index": 1}),
    ("sigmoid_cross_entropy_with_logits",
     {"X": _f(4, 3) * 3,
      "Label": np.array([[0, 1, 1], [1, 0, 1], [1, 1, 0], [0, 0, 1]],
                        np.float32)}, {"ignore_index": 0,
                                       "normalize": True}),
    # concat, slice, one_hot
    ("concat", {"X": [_f(2, 3), _f(2, 5), _f(2, 1)]}, {"axis": 1}),
    ("concat", {"X": [_f(2, 3, 4), _f(1, 3, 4)]}, {"axis": 0}),
    ("concat", {"X": [_f(2, 3), _f(2, 2)]}, {"axis": -1}),
    ("slice", {"Input": _f(3, 8, 5)},
     {"axes": [1], "starts": [0], "ends": [1]}),
    ("slice", {"Input": _f(3, 8, 5)},
     {"axes": [1, 2], "starts": [-3, 1], "ends": [100, -1]}),
    ("slice", {"Input": _f(3, 8, 5)},
     {"axes": [0, 1], "starts": [-10, 5], "ends": [2, -20]}),
    ("slice", {"Input": _f(3, 8, 5)},
     {"axes": [2], "starts": [7], "ends": [9]}),
    ("one_hot", {"X": np.array([[[0], [3], [5]], [[6], [-1], [2]]],
                               np.int64)}, {"depth": 6}),
    ("one_hot", {"X": np.array([4, 0, 9, -7, 1], np.int64)},
     {"depth": 5, "dtype": "bfloat16"}),
    ("one_hot", {"X": np.array([[1], [2]], np.int64)}, {"depth": 3}),
]

# activations: (op, attrs, input)
_pos = _f(3, 5, lo=0.3, hi=3.0)
_x = _f(3, 5) * 2
ACT_CASES = [
    ("relu6", {}, _ties), ("relu6", {"threshold": 3.0}, _ties),
    ("leaky_relu", {}, _ties), ("leaky_relu", {"alpha": 0.3}, _x),
    ("sigmoid", {}, _x), ("logsigmoid", {}, _x * 4), ("tanh", {}, _x),
    ("exp", {}, _x), ("log", {}, _pos), ("sqrt", {}, _pos),
    ("rsqrt", {}, _pos), ("abs", {}, _ties), ("square", {}, _x),
    ("reciprocal", {}, _pos * np.sign(_x)), ("softplus", {}, _x * 8),
    ("softsign", {}, _x), ("elu", {}, _ties), ("elu", {"alpha": 0.7}, _x),
    ("selu", {}, _x), ("swish", {}, _x), ("swish", {"beta": 1.7}, _x),
    ("hard_sigmoid", {}, np.concatenate([_x, [[-2.5, 2.5, 0.0, 1.0,
                                               -1.0]]]).astype(np.float32)),
    ("hard_sigmoid", {"slope": 0.25, "offset": 0.25}, _x),
    ("hard_swish", {}, np.concatenate([_x * 2, [[-3.0, 3.0, 0.0, 6.0,
                                                 -6.0]]]).astype(
        np.float32)),
    ("floor", {}, _x), ("ceil", {}, _x),
    ("round", {}, np.array([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.7, -0.3]],
                           np.float32)),
    ("sin", {}, _x), ("cos", {}, _x), ("erf", {}, _x),
    ("tanh_shrink", {}, _x), ("softshrink", {}, _ties),
    ("softshrink", {"lambda": 0.9}, _x), ("hard_shrink", {}, _ties),
    ("hard_shrink", {"threshold": 1.2}, _x),
    ("thresholded_relu", {}, _ties),
    ("thresholded_relu", {"threshold": 0.3}, _x),
    ("stanh", {}, _x), ("stanh", {"scale_a": 1.1, "scale_b": 0.5}, _x),
    ("relu", {}, _ties), ("gelu", {}, _x), ("gelu", {"approximate": True}, _x),
]
BASE_CASES += [(op, {"X": x}, attrs) for op, attrs, x in ACT_CASES]

FAMILIES = {
    "elementwise": ["elementwise_add", "elementwise_sub", "elementwise_mul",
                    "elementwise_div", "elementwise_min", "elementwise_max",
                    "elementwise_pow", "elementwise_mod",
                    "elementwise_floordiv"],
    "reduce": ["reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
               "reduce_prod", "reduce_all", "reduce_any"],
    "activations": sorted({c[0] for c in ACT_CASES}),
    "other": ["matmul", "pow", "sigmoid_cross_entropy_with_logits",
              "concat", "slice", "one_hot", "fill_constant"],
}
EXACT = {"elementwise_mod", "elementwise_floordiv", "floor", "ceil",
         "round", "slice", "concat", "one_hot", "reduce_all", "reduce_any",
         "reduce_max", "reduce_min"}


def _is_float(a):
    return np.asarray(a[0] if isinstance(a, list) else a).dtype.kind == "f"


def _cases():
    out = []
    for i, (op, ins, attrs) in enumerate(BASE_CASES):
        dtypes = ("float32", "bfloat16") if any(
            _is_float(v) for v in ins.values()) else ("int",)
        out += [pytest.param(op, ins, attrs, dt, id=f"{op}-{i}-{dt}")
                for dt in dtypes]
    return out


def _tree(x, fn):
    return [fn(v) for v in x] if isinstance(x, list) else fn(x)


def _inputs(ins, dtype):
    """(jax inputs, torch inputs): float arrays in ``dtype`` (bf16 rounded
    once, the same values for both), the others as they are."""
    def j(a):
        a = np.asarray(a)
        if a.dtype.kind == "f" and dtype == "bfloat16":
            return jnp.asarray(a, jnp.bfloat16)
        return jnp.asarray(a)

    def p(a):
        a = np.asarray(a)
        t = torch.from_numpy(a)
        return t.to(torch.bfloat16) if a.dtype.kind == "f" and \
            dtype == "bfloat16" else t

    return ({k: _tree(v, j) for k, v in ins.items()},
            {k: _tree(v, p) for k, v in ins.items()})


def _assert_close(p, j, op, dtype, grad, what):
    p_arr, j_arr = to_numpy(p), to_numpy(j)
    assert tuple(p.shape) == tuple(j.shape), what
    if j_arr.dtype.kind in "iub":
        np.testing.assert_array_equal(p_arr.astype(np.int64),
                                      j_arr.astype(np.int64), err_msg=what)
        return
    assert str(p.dtype).replace("torch.", "") == str(j.dtype), what
    if op in EXACT and not grad:
        np.testing.assert_array_equal(p_arr, j_arr, err_msg=what)
        return
    tol = (2e-2 if grad else 1e-2) if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(p_arr, j_arr, rtol=tol, atol=tol,
                               err_msg=what)


def test_the_port_registers_every_op_of_the_families():
    """Each family whole, in both registries, with the same slots, attr
    defaults and differentiability; about 110 op types in the port."""
    for family, ops in FAMILIES.items():
        for op in ops:
            jdef = jax_registry.get_op_def(op)
            pdef = pt_registry.get_op_def(op)
            assert (pdef.inputs, pdef.outputs, pdef.duplicable,
                    pdef.optional, pdef.differentiable) == \
                (jdef.inputs, jdef.outputs, jdef.duplicable, jdef.optional,
                 jdef.differentiable), (family, op)
            assert {k: repr(v) for k, v in pdef.attrs.items()} == \
                {k: repr(v) for k, v in jdef.attrs.items()}, (family, op)
    assert len(FAMILIES["activations"]) == 32
    # other test files register ops of their own, named "_test..."
    ported = {t for t in pt_registry._REGISTRY if not t.startswith("_")}
    assert 107 <= len(ported) <= 113
    assert ported <= set(jax_registry._REGISTRY)


@pytest.mark.parametrize("op_type,ins,attrs,dtype", _cases())
def test_op_and_grad_match_jax(op_type, ins, attrs, dtype):
    jdef = jax_registry.get_op_def(op_type)
    pdef = pt_registry.get_op_def(op_type)
    jattrs, pattrs = jdef.canonical_attrs(attrs), pdef.canonical_attrs(attrs)
    jins, pins = _inputs(ins, dtype)
    jout = jdef.compute(jins, jattrs)
    pout = pdef.compute(pins, pattrs, torch.device("cpu"))
    assert set(pout) == set(jout)
    for slot in jout:
        _assert_close(pout[slot], jout[slot], op_type, dtype, False, slot)
    if not jdef.differentiable or dtype == "int":
        with pytest.raises(KeyError):
            pt_registry.get_op_def(op_type + "_grad")
        return
    rng = np.random.RandomState(len(op_type) + len(ins))
    cts = {}
    for slot, out in jout.items():
        ct = rng.standard_normal(out.shape).astype(np.float32)
        cts[slot + "@GRAD"] = ct
    jcts, pcts = _inputs(cts, dtype)
    jg = jax_registry.get_op_def(op_type + "_grad").compute(
        {**jins, **jcts}, jattrs)
    pg = pt_registry.get_op_def(op_type + "_grad").compute(
        {**pins, **pcts}, pattrs, torch.device("cpu"))
    assert set(pg) == set(jg)
    for slot in jg:
        p_list, j_list = pg[slot], jg[slot]
        if not isinstance(p_list, list):
            p_list, j_list = [p_list], [j_list]
        for p, j in zip(p_list, j_list):
            _assert_close(p, j, op_type, dtype, True, slot)
            assert not p.requires_grad


def test_tie_gradients_follow_jax():
    """The tie rules the formulas keep, read straight off the grads: half
    to each side of ``jnp.clip``'s and ``jnp.maximum``'s ties, the
    branch's own gradient for ``jnp.where`` (leaky_relu at 0: 1), and
    ``jnp.abs``' 1 at 0."""
    def grad(op, x, attrs=None):
        d = pt_registry.get_op_def(op + "_grad")
        t = torch.tensor(x, dtype=torch.float32)
        return d.compute({"X": t, "Out@GRAD": torch.ones_like(t)},
                         d.attrs | (attrs or {}), "cpu")["X@GRAD"].tolist()

    assert grad("relu6", [0.0, 6.0, 3.0, -1.0, 7.0]) == \
        [0.5, 0.5, 1.0, 0.0, 0.0]
    assert grad("leaky_relu", [0.0, -1.0]) == [1.0, pytest.approx(0.02)]
    assert grad("relu", [0.0, 1.0]) == [0.0, 1.0]
    assert grad("abs", [0.0, -2.0]) == [1.0, -1.0]


def test_one_hot_never_indexes_out_of_range():
    """An id out of range or negative gives a zero row, on the meta
    device too (shape inference), where ``F.one_hot`` would raise."""
    d = pt_registry.get_op_def("one_hot")
    ids = torch.tensor([[7], [-1], [2]])
    out = d.compute({"X": ids}, d.canonical_attrs({"depth": 4}), "cpu")
    assert out["Out"].tolist() == [[0, 0, 0, 0], [0, 0, 0, 0],
                                   [0, 0, 1, 0]]
    meta = d.compute({"X": ids.to("meta")},
                     d.canonical_attrs({"depth": 4}), "meta")["Out"]
    assert meta.shape == (3, 4) and meta.dtype == torch.float32
