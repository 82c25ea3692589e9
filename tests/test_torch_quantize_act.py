"""The int8 ops' activation quantisation (``quantize_act`` in
``paddle_tpu_torch/ops/quant.py``) against the JAX package's, on the CPU.

The JAX package computes ``clip(round(f32(x) / sx * bnd), -bnd, bnd)`` as
part of ``conv2d_int8`` (``paddle_tpu/ops/quant.py:325``), fused by XLA
into the s8 dot's operand.  It comes out unchanged through that op with
``out_dtype="int32"`` and a 1x1 identity filter (the int32 accumulator of
channel c is x8[..., c] itself), so the plain version is held
``array_equal`` to it over f32 and bf16 x, exact .5 ties (which round to
even), values beyond +-bnd (which saturate) and an ``InScale`` at the
1e-8 floor.  The wrapper takes the plain version on CPU and meta tensors
and launches nothing; the CUDA kernel (``csrc/quantize_act.cu``) is held
``torch.equal`` to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX ops)
from paddle_tpu.core import registry as jax_registry
from torch_port_helpers import to_numpy

import paddle_tpu_torch as pt  # noqa: F401  (registers the port's ops)
from paddle_tpu_torch.ops import quant as Q


def _jax_quantized(x, in_scale, bnd):
    """x8 as the JAX package's conv2d_int8 quantises x [N, H, W, C]
    (NHWC), read through a 1x1 identity filter into the int32 out."""
    c = x.shape[-1]
    jdef = jax_registry.get_op_def("conv2d_int8")
    ins = {"Input": jnp.asarray(x),
           "Filter": jnp.asarray(np.eye(c, dtype=np.int8)[:, :, None, None]),
           "FilterScale": jnp.ones((c, 1, 1, 1), jnp.float32),
           "InScale": jnp.asarray(np.float32([in_scale]))}
    out = jdef.compute(ins, jdef.canonical_attrs({
        "data_format": "NHWC", "out_dtype": "int32", "max_range": bnd}))
    return np.asarray(out["Output"])


def _port_quantized(x, in_scale, bnd):
    xt = torch.from_numpy(np.asarray(x, np.float32))
    if str(x.dtype) == "bfloat16":
        xt = xt.to(torch.bfloat16)
    sx = torch.clamp_min(torch.tensor(np.float32(in_scale)), 1e-8)
    return Q.quantize_act(xt, sx, bnd)


def _case(name, dtype):
    rng = np.random.RandomState(11)
    shape = (2, 5, 7, 12)
    bnd, in_scale = 127.0, 3.7
    if name == "random":
        x = rng.standard_normal(shape) * 2.0
    elif name == "ties":
        # sx = bnd = 64: x / sx * bnd is x exactly, so k + 0.5 is a tie
        bnd = in_scale = 64.0
        x = rng.randint(-70, 70, shape) + 0.5
    elif name == "saturating":
        x = rng.standard_normal(shape) * 40.0
    else:  # the 1e-8 floor: InScale below it is clamped to it
        in_scale = 1e-9
        x = rng.standard_normal(shape) * 2e-8
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(jnp.bfloat16)
    return x, in_scale, bnd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["random", "ties", "saturating", "floor"])
def test_quantize_act_matches_jax(name, dtype):
    x, in_scale, bnd = _case(name, dtype)
    want = _jax_quantized(x, in_scale, bnd)
    launches = Q.quantize_act.launches
    got = _port_quantized(x, in_scale, bnd)
    assert Q.quantize_act.launches == launches    # the plain version
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(to_numpy(got).astype(np.int32), want)
    if name == "ties":
        xf = np.asarray(x, np.float32)
        assert np.all(np.abs(xf - np.round(xf)) == 0.5)
        assert np.all(to_numpy(got) % 2 == 0)     # half to even
    if name == "saturating":
        assert int(np.abs(to_numpy(got).astype(np.int32)).max()) == 127


def test_quantize_act_takes_the_plain_version_on_cpu_and_meta():
    """The wrapper's dispatch: CPU and meta tensors run the plain version
    and launch nothing; meta keeps the shape and gives int8."""
    x = torch.randn(3, 4, 5)
    sx = torch.tensor(2.5)
    launches, copies = Q.quantize_act.launches, Q.quantize_act.copies
    assert torch.equal(Q.quantize_act(x, sx, 127.0),
                       Q.quantize_act_plain(x, sx, 127.0))
    ym = Q.quantize_act(x.to("meta").permute(2, 0, 1), sx.to("meta"), 127.0)
    assert ym.device.type == "meta" and ym.shape == (5, 3, 4)
    assert ym.dtype == torch.int8
    assert Q.quantize_act.launches == launches
    assert Q.quantize_act.copies == copies


@pytest.mark.parametrize("op", ["conv2d_int8", "mul_int8"])
def test_int8_ops_quantize_through_the_wrapper(op, monkeypatch):
    """Both int8 ops quantise a float activation through ``quantize_act``
    (once a call), and not an int8 one."""
    calls = []
    real = Q.quantize_act

    def spy(x, sx, bnd):
        calls.append(x.dtype)
        return real(x, sx, bnd)

    monkeypatch.setattr(Q, "quantize_act", spy)
    opdef = pt.core.registry.get_op_def(op)
    rng = np.random.RandomState(2)
    for x_dtype in (torch.float32, torch.int8):
        if op == "conv2d_int8":
            x = torch.from_numpy(rng.standard_normal((2, 4, 4, 16)).astype(
                np.float32))
            ins = {"Input": x, "Filter": torch.ones((8, 16, 1, 1),
                                                    dtype=torch.int8),
                   "FilterScale": torch.ones((8, 1, 1, 1)),
                   "InScale": torch.tensor([2.0])}
            attrs = {"data_format": "NHWC"}
            slot = "Input"
        else:
            x = torch.from_numpy(rng.standard_normal((6, 16)).astype(
                np.float32))
            ins = {"X": x, "Y": torch.ones((16, 8), dtype=torch.int8),
                   "Scale": torch.ones((1, 8)), "InScale": torch.tensor([2.0])}
            attrs = {}
            slot = "X"
        if x_dtype == torch.int8:
            ins[slot] = torch.clamp(ins[slot] * 20, -127, 127).to(torch.int8)
        opdef.compute(ins, opdef.canonical_attrs(attrs), torch.device("cpu"))
    assert calls == [torch.float32]
