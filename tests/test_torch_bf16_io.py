"""bfloat16 at the executor's edges: fetch, feed, save and load.

The JAX package hands bf16 values to numpy as ``ml_dtypes.bfloat16``
arrays, and ``np.savez`` stores them as ``|V2`` records.  The port
returns, takes, writes and reads the same arrays; every comparison here
is of bit patterns (``array_equal`` of int16 views).
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.program import Program as JaxProgram
from paddle_tpu.core.scope import Scope as JaxScope
from torch_port_helpers import fresh_port_programs

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import types as pt_types
from paddle_tpu_torch.core.program import Program as PortProgram


def _bits(a):
    assert a.dtype == ml_dtypes.bfloat16, a.dtype
    return np.asarray(a).view(np.int16)


def _feed(seed):
    return np.random.RandomState(seed).standard_normal(
        (3, 5)).astype(np.float32)


def _cast_program():
    """x (f32) -> cast to bf16 -> scale (in bf16) -> fetch both bf16
    vars; y (a bf16 feed) -> cast to f32 -> fetch.  Built once, by the
    JAX package."""
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data("x", shape=[5], dtype="float32")
        y = fluid.layers.data("y", shape=[5], dtype="bfloat16")
        xb = fluid.layers.cast(x, "bfloat16")
        xs = fluid.layers.scale(xb, scale=3.0, bias=0.5)
        yf = fluid.layers.cast(y, "float32")
    return main, [xb.name, xs.name, yf.name]


def test_bf16_fetch_and_feed_match_the_jax_package():
    main, fetch = _cast_program()
    x = _feed(0)
    y = _feed(1).astype(ml_dtypes.bfloat16)
    feed = {"x": x, "y": y}
    jout = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=JaxScope())
    port = PortProgram.from_dict(main.to_dict())
    pout = pt.Executor(pt.CPUPlace()).run(port, feed=feed,
                                          fetch_list=fetch, scope=pt.Scope())
    for name, j, p in zip(fetch[:2], jout, pout):
        np.testing.assert_array_equal(_bits(p), _bits(np.asarray(j)),
                                      err_msg=name)
    assert pout[2].dtype == np.float32
    np.testing.assert_array_equal(pout[2], np.asarray(jout[2]))
    np.testing.assert_array_equal(pout[2], y.astype(np.float32))
    # return_numpy=False hands back the tensor itself
    raw, = pt.Executor(pt.CPUPlace()).run(
        port, feed=feed, fetch_list=fetch[:1], scope=pt.Scope(),
        return_numpy=False)
    assert raw.dtype == torch.bfloat16
    np.testing.assert_array_equal(raw.view(torch.int16).numpy(),
                                  _bits(pout[0]))


def test_bf16_save_and_load_round_trip_bit_for_bit(tmp_path):
    """save_combine of a bf16 var writes the archive the JAX package
    writes, and load_combine reads either package's archive back bit for
    bit (numpy keeps the bf16 array as |V2 records)."""
    w = _feed(2).astype(ml_dtypes.bfloat16)
    f32 = _feed(3)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    jscope = JaxScope()
    jscope.var("w").set(np.asarray(w))
    jscope.var("f").set(f32)
    fluid.Executor(fluid.CPUPlace()).run(
        _jax_combined("save_combine", str(theirs / "params")),
        scope=jscope)
    with fresh_port_programs():
        exe = pt.Executor(pt.CPUPlace())
        scope = pt.Scope()
        scope.var("w").set(pt_types.from_numpy(w, "w"))
        scope.var("f").set(torch.from_numpy(f32))
        with pt.scope_guard(scope):
            pt.io.save_vars(exe, str(ours), ["w", "f"], "params")
        for src in (ours, theirs):
            back = pt.Scope()
            with pt.scope_guard(back):
                pt.io.load_vars(exe, str(src), ["w", "f"], "params")
            got = back.find_var("w").get()
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          _bits(w), err_msg=str(src))
            np.testing.assert_array_equal(back.find_var("f").get().numpy(),
                                          f32)
    with np.load(ours / "params.npz") as a, \
            np.load(theirs / "params.npz") as b:
        assert a["w"].dtype == b["w"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(a["w"].view(np.int16),
                                      b["w"].view(np.int16))


def _jax_combined(op_type, path):
    prog = JaxProgram()
    names = ["w", "f"]
    slots = ({"X": names}, {}) if op_type == "save_combine" else \
        ({}, {"Out": names})
    prog.global_block().append_op(type=op_type, inputs=slots[0],
                                  outputs=slots[1],
                                  attrs={"file_path": path})
    return prog


def test_bf16_without_ml_dtypes_raises_a_typed_error(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    t = torch.zeros(2, dtype=torch.bfloat16)
    with pytest.raises(pt_types.BFloat16NumpyError, match="'logits'"):
        pt_types.to_numpy(t, "logits")
    # reading bf16 records back needs no ml_dtypes
    back = pt_types.from_numpy(np.zeros(2, np.int16).view("V2"), "w")
    assert back.dtype == torch.bfloat16
