"""The port's fused matmul epilogue against the JAX package's.

The same numpy inputs go to ``paddle_tpu.ops.epilogue`` and
``paddle_tpu_torch.ops.epilogue``:

- The stage grammar: the same specs, attrs and refusals.
- ``fc_epilogue`` over every fc stage subset of ``enumerate_specs("fc")``
  plus the tanh gelu, through the IR op under each flag mode: the port's
  ``interpret`` (the kernel's plain version) against the JAX package's
  ``interpret`` (the Pallas kernel under its interpreter), and ``off``,
  ``xla`` and ``on`` (the unfused chain on the CPU in both) against the
  JAX package's.  f32 within atol=rtol=1e-5 (torch and XLA sum the
  product in other orders).  bf16 within atol=rtol=2e-2: both sides
  accumulate in f32 and round once (interpret) or round the product and
  each add to bf16 (the chain), so one bf16 step (2^-8 relative) may part
  them at each rounding.
- The synthesised ``fc_epilogue_grad`` against the JAX package's, with
  the same upstream grads, in f32 (1e-5) and bf16 (2e-2 of the grad's
  scale, as above), and a case whose pre-activations are exactly 0: the
  chain's relu is ``maximum(y, 0)``, whose gradient at a tie is 0.5 in
  both packages (``torch.relu``'s would be 0, ``clamp_min``'s 1).
- ``transpiler.fuse_epilogue`` on small fc nets: the port's pass writes
  the JAX pass's program; the fused program computes what the unfused
  one does, bit for bit in f32, under every flag mode the CPU runs, and
  what the JAX package's fused program computes (1e-5).

Every test that sets the ``fc_epilogue`` flag of either package restores
it to ``off`` in ``finally``: flags are process-global and the port's
tests share workers with the JAX suite's.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import framework as jax_framework
from paddle_tpu import layers as jax_layers
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.core.scope import scope_guard as jax_scope_guard
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.ops import epilogue as jax_ep
from paddle_tpu.transpiler import fuse_epilogue as jax_fuse_epilogue
from torch_port_helpers import fresh_port_programs, to_numpy

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.ops import epilogue as ep

# every fc stage subset, and the tanh gelu beside the erf one
FC_SPECS = [(s.to_attr(), False) for s in ep.enumerate_specs("fc")] + [
    (s.to_attr(), True) for s in ep.enumerate_specs("fc") if s.act == "gelu"]
FC_IDS = [f"{a or 'none'}{'-tanh' if t else ''}" for a, t in FC_SPECS]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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


def _fc_ins(attr, dtype, seed=7, tie=False):
    """X [2,6,24] (x_num_col_dims 2), Y [24,16], Bias [16], Residual
    [2,6,16], as numpy arrays in ``dtype``.  ``tie`` zeroes the first
    rows of X and the bias and residual there, so those outputs are
    exactly 0 before the act."""
    spec = ep.EpilogueSpec.from_attr(attr)
    rng = np.random.RandomState(seed)
    ins = {"X": rng.standard_normal((2, 6, 24)),
           "Y": rng.standard_normal((24, 16)) / np.sqrt(24)}
    if "bias" in spec:
        ins["Bias"] = rng.standard_normal(16)
    if "residual" in spec:
        ins["Residual"] = rng.standard_normal((2, 6, 16))
    if tie:
        ins["X"][0, :3] = 0
        if "Bias" in ins:
            ins["Bias"][::2] = 0
        if "Residual" in ins:
            ins["Residual"][0, :3] = 0
    cast = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    return {k: np.asarray(v, np.float32).astype(cast)
            for k, v in ins.items()}


def _attrs(attr, approximate):
    spec = ep.EpilogueSpec.from_attr(attr)
    return {"x_num_col_dims": 2, "act": spec.act,
            "approximate": approximate, "epilogue": attr}


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _close(got, want, dtype, err_msg=""):
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, err_msg
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale, err_msg=err_msg)


# ---------------------------------------------------------------------------
# the stage grammar
# ---------------------------------------------------------------------------

def test_stage_grammar_matches_jax():
    for anchor in ("conv", "conv_bn", "fc", "int8"):
        assert [s.to_attr() for s in ep.enumerate_specs(anchor)] == \
            [s.to_attr() for s in jax_ep.enumerate_specs(anchor)]
    assert ep.spec_attr(bias=True, residual=True, act="gelu") == \
        jax_ep.spec_attr(bias=True, residual=True, act="gelu") == \
        "bias+residual+gelu"
    for bad in ("bias+banana", "bias+bias", "relu+bias", "relu+gelu",
                "argmax+requantize"):
        with pytest.raises(ValueError):
            jax_ep.EpilogueSpec.from_attr(bad)
        with pytest.raises(ValueError):
            ep.EpilogueSpec.from_attr(bad)
    assert ep.EpilogueSpec.from_attr("bias+relu").act == "relu"
    with pytest.raises(ValueError):
        ep.spec_attr(act="banana")


def test_fc_epilogue_op_def_matches_jax():
    jdef, pdef = (r.get_op_def("fc_epilogue")
                  for r in (jax_registry, pt_registry))
    assert (pdef.inputs, pdef.outputs, pdef.optional) == \
        (jdef.inputs, jdef.outputs, jdef.optional)
    assert {k: repr(v) for k, v in pdef.attrs.items()} == \
        {k: repr(v) for k, v in jdef.attrs.items()}


# ---------------------------------------------------------------------------
# fc_epilogue: every stage subset, every flag mode, both dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attr,approximate", FC_SPECS, ids=FC_IDS)
def test_fc_epilogue_op_matches_jax_in_every_flag_mode(attr, approximate,
                                                       dtype):
    ins = _fc_ins(attr, dtype)
    attrs = _attrs(attr, approximate)
    jdef = jax_registry.get_op_def("fc_epilogue")
    pdef = pt_registry.get_op_def("fc_epilogue")
    outs = {}
    for mode in ("interpret", "off", "xla", "on"):
        with fc_flag(mode):
            want = jdef.compute({k: jnp.asarray(v) for k, v in ins.items()},
                                jdef.canonical_attrs(attrs))["Out"]
            got = pdef.compute({k: _to_torch(v) for k, v in ins.items()},
                               pdef.canonical_attrs(attrs),
                               torch.device("cpu"))["Out"]
        assert str(got.dtype) == f"torch.{dtype}" and \
            str(want.dtype) == dtype
        _close(got, want, dtype, err_msg=mode)
        outs[mode] = got
    # off, xla and on all run the chain on the CPU
    assert torch.equal(outs["off"], outs["xla"])
    assert torch.equal(outs["off"], outs["on"])
    if dtype == "float32":     # the f32 accumulator order is the chain's
        assert torch.equal(outs["interpret"], outs["off"])


def test_fc_epilogue_flag_modes_choose_their_implementation():
    """``pallas`` asks for the CUDA kernel and refuses a CPU tensor;
    ``interpret`` adds bias and residual to the f32 accumulator, the
    chain rounds each add to bf16; no mode launches a kernel here."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    launches = ep.fc_epilogue.launches
    with pytest.raises(ValueError, match="CPU tensor"):
        ep.fc_epilogue(x, w, b, impl="pallas")
    xb, wb, bb = (t.bfloat16() for t in (x, w, b))
    acc = ep.fc_epilogue(xb, wb, bb, act="relu", impl="interpret")
    chain = ep.fc_epilogue(xb, wb, bb, act="relu", impl="xla")
    want_acc = torch.relu(xb.float() @ wb.float() + bb.float()).bfloat16()
    want_chain = torch.relu((xb @ wb) + bb)
    assert torch.equal(acc, want_acc) and torch.equal(chain, want_chain)
    assert torch.equal(ep.fc_epilogue(xb, wb, bb, act="relu"), chain)
    assert ep.fc_epilogue.launches == launches
    with pytest.raises(TypeError, match="both be float32 or both bfloat16"):
        ep._check(x, wb, None, None)
    with pytest.raises(ValueError, match="bias"):
        ep._check(x, w, torch.zeros(4), None)


# (K, N, dtype, x/w 16-byte aligned, path): the AMP step's three shapes,
# K or N off the 16-byte row, K = 0, a misaligned base, and f32
FC_PATH_CASES = [
    (512, 512, "bfloat16", True, "wgmma"),
    (512, 2048, "bfloat16", True, "wgmma"),
    (2048, 512, "bfloat16", True, "wgmma"),
    (8, 8, "bfloat16", True, "wgmma"),
    (130, 77, "bfloat16", True, "mma_sync"),
    (64, 129, "bfloat16", True, "mma_sync"),
    (3, 5, "bfloat16", True, "mma_sync"),
    (0, 16, "bfloat16", True, "mma_sync"),
    (512, 512, "bfloat16", False, "mma_sync"),
    (512, 512, "float32", True, "f32"),
    (130, 77, "float32", False, "f32"),
]


@pytest.mark.parametrize("k,n,dtype,aligned,path", FC_PATH_CASES)
def test_fc_kernel_path_follows_what_tma_can_address(k, n, dtype, aligned,
                                                     path):
    """The kernel path a call takes is a plain function of the shape and
    the operands' alignment: bf16 goes to the wgmma kernel where TMA can
    address both operands' rows (K > 0, K and N multiples of 8, x and w
    on 16 bytes), to the mma.sync kernel otherwise; f32 to the CUDA-core
    kernel.  Every path has a launch counter, and the total stays."""
    assert ep.fc_kernel_path(k, n, getattr(torch, dtype), aligned) == path
    assert set(ep.fc_epilogue.launches_by_path) == set(ep.FC_PATHS)
    assert path in ep.FC_PATHS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attr,approximate",
                         [s for s in FC_SPECS if s[0]],
                         ids=[i for s, i in zip(FC_SPECS, FC_IDS) if s[0]])
def test_fc_epilogue_grad_matches_jax(attr, approximate, dtype):
    _grad_case(attr, approximate, dtype, tie=False)


@pytest.mark.parametrize("attr", ["relu", "bias+relu", "bias+residual+relu"])
def test_fc_epilogue_grad_relu_tie_is_one_half(attr):
    """Pre-activations of exactly 0: the chain's relu passes half the
    upstream grad, as ``jnp.maximum``'s gradient does."""
    gx = _grad_case(attr, False, "float32", tie=True)
    ins = _fc_ins(attr, "float32", tie=True)
    g = _cotangent(ins, "float32")
    # rows 0-2 of batch 0 have y == 0 in every column kept at zero bias
    cols = slice(0, 16, 2) if "bias" in attr else slice(None)
    tied_w = ins["Y"][:, cols]
    want = 0.5 * g[0, :3, cols] @ tied_w.T
    np.testing.assert_allclose(gx[0, :3], want, rtol=1e-5, atol=1e-6)


def _cotangent(ins, dtype):
    g = np.random.RandomState(11).standard_normal((2, 6, 16))
    if dtype == "bfloat16":
        return g.astype(np.float32).astype(jnp.bfloat16)
    g = g.astype(np.float32)
    if "Bias" not in ins:
        return g
    # with a zero bias at even columns only those are tied in rows 0-2
    # (the odd ones hold a bias); no cotangent there keeps the check on
    # the tie alone
    g = g.copy()
    g[0, :3, 1::2] = 0
    return g


def _grad_case(attr, approximate, dtype, tie):
    ins = _fc_ins(attr, dtype, tie=tie)
    attrs = _attrs(attr, approximate)
    g = _cotangent(ins, dtype)
    jdef = jax_registry.get_op_def("fc_epilogue_grad")
    pdef = pt_registry.get_op_def("fc_epilogue_grad")
    assert (pdef.inputs, pdef.outputs, pdef.optional) == \
        (jdef.inputs, jdef.outputs, jdef.optional)
    all_ins = {**ins, "Out@GRAD": g}
    with fc_flag("interpret"):
        jg = jdef.compute({k: jnp.asarray(v) for k, v in all_ins.items()},
                          jdef.canonical_attrs(attrs))
        pg = pdef.compute({k: _to_torch(v) for k, v in all_ins.items()},
                          pdef.canonical_attrs(attrs), torch.device("cpu"))
    assert set(pg) == set(jg) == {s + "@GRAD" for s in ins}
    for slot in jg:
        assert str(pg[slot].dtype) == f"torch.{jg[slot].dtype}", slot
        _close(pg[slot], jg[slot], dtype, err_msg=slot)
    return to_numpy(pg["X@GRAD"])


# ---------------------------------------------------------------------------
# transpiler.fuse_epilogue on fc nets
# ---------------------------------------------------------------------------

def _fc_net(layers, act, residual):
    """mul -> bias -> [residual] -> [act] -> fc, as the JAX package's
    tests/test_epilogue.py builds it."""
    x = layers.data("x", shape=[24], dtype="float32")
    h = layers.fc(x, size=24, act=None if residual else act, bias_attr=True)
    if residual:
        h = layers.elementwise_add(h, x)
        if act == "relu":
            h = layers.relu(h)
        elif act == "gelu":
            h = layers.gelu(h)
    return layers.fc(h, size=4, bias_attr=True)


def _canon(program):
    return json.dumps(program.to_dict(), sort_keys=True)


@pytest.mark.parametrize("act,residual", [("relu", False), ("gelu", False),
                                          (None, True), ("relu", True)])
def test_fuse_epilogue_matches_jax_and_keeps_the_result(act, residual):
    from conftest import _reset_program_state

    _reset_program_state()
    jpred = _fc_net(jax_layers, act, residual)
    jmain = jax_framework.default_main_program()
    assert jax_fuse_epilogue(jmain, protected=[jpred.name],
                             anchors=("fc",)) == 2
    rng = np.random.RandomState(3)
    feed = {"x": rng.standard_normal((6, 24)).astype(np.float32)}
    with fresh_port_programs():
        pred = _fc_net(pt.layers, act, residual)
        prog = pt.default_main_program()
        exe = pt.Executor(pt.CPUPlace())
        scope = pt.Scope()
        np.random.seed(0)
        exe.run(pt.default_startup_program(), scope=scope)
        ref, = exe.run(prog, feed=feed, fetch_list=[pred], scope=scope)
        assert pt.transpiler.fuse_epilogue(prog, protected=[pred.name],
                                           anchors=("fc",)) == 2
        assert _canon(prog) == _canon(jmain)
        fused = [op for op in prog.global_block().ops
                 if op.type == "fc_epilogue"]
        assert [op.attrs["epilogue"] for op in fused] == [
            ep.spec_attr(bias=True, residual=residual, act=act or ""),
            ep.spec_attr(bias=True)]
        for mode in ("off", "xla", "interpret", "on"):
            with fc_flag(mode):
                got, = exe.run(prog, feed=feed, fetch_list=[pred],
                               scope=scope)
            np.testing.assert_array_equal(ref, got, err_msg=mode)
    # the JAX package runs its fused program from the same seed: the
    # same weights (both draw them with numpy), the same result
    jexe = fluid.Executor(fluid.CPUPlace())
    with jax_scope_guard(JaxScope()):
        np.random.seed(0)
        jexe.run(jax_framework.default_startup_program())
        with fc_flag("interpret"):
            want, = jexe.run(jmain, feed=feed, fetch_list=[jpred])
    np.testing.assert_allclose(ref, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_fuse_epilogue_skips_what_it_cannot_fuse_and_refuses_conv():
    """A bare mul fuses nothing; an intermediate with a second consumer
    never fuses; the conv anchors (ported with the ResNet slice), the
    default included, find no conv here and change nothing; an unknown
    anchor is refused before anything changes."""
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[8], dtype="float32")
        h = pt.layers.fc(x, size=8, bias_attr=False)
        a = pt.layers.relu(h)
        b = pt.layers.elementwise_mul(h, h)
        pred = pt.layers.elementwise_add(a, b)
        prog = pt.default_main_program()
        before = _canon(prog)
        assert pt.transpiler.fuse_epilogue(prog, protected=[pred.name],
                                           anchors=("fc",)) == 0
        assert _canon(prog) == before
        for anchors in (("conv",), ("fc", "conv_bn"),
                        pt.transpiler.EpilogueFusionTranspiler.ANCHORS):
            assert pt.transpiler.fuse_epilogue(
                prog, protected=[pred.name], anchors=anchors) == 0
        assert pt.transpiler.fuse_epilogue(prog, protected=[pred.name]) == 0
        with pytest.raises(ValueError, match="unknown epilogue anchor"):
            pt.transpiler.fuse_epilogue(prog, anchors=("fc", "conv3d"))
        assert _canon(prog) == before
