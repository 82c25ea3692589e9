"""The port's flash attention against the JAX package's kernels.

On the CPU the port's wrappers take their plain versions; they are held
against ``paddle_tpu``'s Pallas kernels run in interpret mode.  Forward:
``out`` from ``flash_attention``, ``lse`` from ``flash_attention_lse``
cut to Tq.  Backward: ``flash_attention_bwd`` (P recomputed from lse)
against ``jax.vjp`` of the same calls, with an lse cotangent through
``flash_attention_lse``.  f32 agrees within atol=rtol=1e-5 (another
summation order); bf16 is compared in f32 within 2e-2 (the Pallas
forward rounds P to bf16 per block, the plain version keeps it in f32,
so O and delta differ at bf16 precision).  The CUDA kernels themselves
are held against the plain versions in test_torch_cuda.py.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import (flash_attention,
                                           flash_attention_lse)
from torch_port_helpers import to_numpy

from paddle_tpu_torch.ops import flash_attention as fa

# (B, H, Tq, Tk, D, causal, dtype)
CASES = [
    (1, 2, 40, 40, 32, True, "float32"),
    (1, 2, 40, 40, 32, False, "float32"),
    (2, 2, 24, 56, 16, True, "float32"),      # Tq < Tk, bottom-right
    (1, 2, 56, 24, 16, True, "float32"),      # Tq > Tk: fully masked rows
    (1, 3, 37, 45, 32, False, "float32"),     # ragged T
    (1, 2, 48, 48, 32, True, "bfloat16"),
    (1, 2, 37, 61, 16, True, "bfloat16"),
    (1, 2, 40, 40, 64, True, "bfloat16"),
    (1, 2, 33, 50, 128, False, "bfloat16"),   # D 128, Tq != Tk
    (1, 2, 56, 24, 64, True, "bfloat16"),     # Tq > Tk: fully masked rows
    (1, 3, 37, 45, 32, False, "bfloat16"),    # ragged T
]


def _inputs(b, h, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for t in (tq, tk, tk)]


@pytest.mark.parametrize("b,h,tq,tk,d,causal,dtype", CASES)
def test_plain_matches_pallas_interpret(b, h, tq, tk, d, causal, dtype):
    q, k, v = _inputs(b, h, tq, tk, d, seed=tq * 7 + tk)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = (jnp.asarray(x, dtype=dtype) for x in (q, k, v))
    jout = flash_attention(jq, jk, jv, causal=causal, impl="interpret",
                           block_q=16, block_k=16)
    _, jlse = flash_attention_lse(jq, jk, jv, causal=causal,
                                  impl="interpret", block_q=16, block_k=16)
    tq_, tk_, tv_ = (torch.from_numpy(x).to(getattr(torch, dtype))
                     for x in (q, k, v))
    launches = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(tq_, tk_, tv_, causal=causal)
    assert fa.flash_attention_fwd.launches == launches  # CPU: no kernel
    assert out.dtype == tq_.dtype and tuple(out.shape) == (b, h, tq, d)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b * h, tq)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(to_numpy(out), to_numpy(jout), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(lse.numpy(), to_numpy(jlse)[:, :tq],
                               rtol=tol, atol=tol)
    if causal and tq > tk:
        dead = tq - tk                       # rows that see no key
        assert (out[:, :, :dead].float() == 0).all()
        assert (lse.reshape(b, h, tq)[:, :, :dead] == -1e30).all()
    assert out.float().isfinite().all() and not lse.isnan().any()


def test_bf16_rows_must_start_on_16_bytes():
    """The rule the bf16 kernel's 16-byte copies need, and the wrapper
    checks before a launch: the model's permuted [B,T,H,D] views pass,
    a view 2 bytes into a chunk or with an odd row stride does not."""
    x = torch.zeros((2, 7, 4, 64), dtype=torch.bfloat16)
    assert fa._aligned(x.permute(0, 2, 1, 3))
    assert fa._aligned(x[:1].permute(0, 2, 1, 3))
    wide = torch.zeros((2, 4, 7, 72), dtype=torch.bfloat16)
    assert not fa._aligned(wide[..., 1:65])
    assert fa._aligned(wide[..., 8:72])
    odd = torch.zeros((2, 4, 7, 68), dtype=torch.bfloat16)
    assert not fa._aligned(odd[..., :64])
    # a dim of extent 1 never steps its stride
    assert fa._aligned(odd[:1, :1, :1, :64])


def test_wrapper_takes_plain_version_on_meta():
    q = torch.empty((2, 4, 10, 32), device="meta")
    k = torch.empty((2, 4, 12, 32), device="meta")
    out, lse = fa.flash_attention_fwd(q, k, k, causal=True)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 4, 10, 32)
    assert tuple(lse.shape) == (8, 10)


@pytest.mark.parametrize("b,h,tq,tk,d,causal,dtype", CASES)
def test_plain_bwd_matches_pallas_interpret_vjp(b, h, tq, tk, d, causal,
                                                dtype):
    q, k, v = _inputs(b, h, tq, tk, d, seed=tq * 5 + tk)
    do = np.random.RandomState(tk).standard_normal(
        (b, h, tq, d)).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(x, dtype=dtype) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: flash_attention(
        a, b_, c, causal=causal, impl="interpret", block_q=16,
        block_k=16), jq, jk, jv)
    want = vjp(jdo)
    tq_, tk_, tv_, tdo = (torch.from_numpy(x).to(getattr(torch, dtype))
                          for x in (q, k, v, do))
    launches = dict(fa.flash_attention_bwd.launches)
    out, lse = fa.flash_attention_fwd(tq_, tk_, tv_, causal=causal)
    got = fa.flash_attention_bwd(tq_, tk_, tv_, out, lse, tdo,
                                 causal=causal)
    assert fa.flash_attention_bwd.launches == launches  # CPU: no kernel
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tq_.dtype, name
        np.testing.assert_allclose(to_numpy(g), to_numpy(w), rtol=tol,
                                   atol=tol, err_msg=name)
    if causal and tq > tk:
        assert (got[0][:, :, :tq - tk].float() == 0).all()


def test_lse_cotangent_matches_pallas_interpret_vjp():
    """flash_attention_lse: the autograd Function with an lse cotangent
    folded into delta (the JAX lse is padded to the 16-row tile)."""
    b, h, tq, tk, d = 1, 2, 37, 45, 32
    q, k, v = _inputs(b, h, tq, tk, d, seed=11)
    rng = np.random.RandomState(12)
    do = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    dlse = rng.standard_normal((b * h, tq)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    (_, jlse), vjp = jax.vjp(lambda a, b_, c: flash_attention_lse(
        a, b_, c, causal=True, impl="interpret", block_q=16, block_k=16),
        jq, jk, jv)
    jdlse = np.zeros(jlse.shape, np.float32)
    jdlse[:, :tq] = dlse
    want = vjp((jnp.asarray(do), jnp.asarray(jdlse)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fwd = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_lse(*leaves, causal=True)
    got = torch.autograd.grad((out, lse), leaves,
                              (torch.from_numpy(do), torch.from_numpy(dlse)))
    assert fa.flash_attention_fwd.launches == fwd
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), to_numpy(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_autograd_function_gives_shapes_on_meta():
    q = torch.empty((2, 4, 10, 32), device="meta", requires_grad=True)
    k = torch.empty((2, 4, 12, 32), device="meta", requires_grad=True)
    out, lse = fa.flash_attention_lse(q, k, k, causal=True)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 4, 10, 32)
    assert tuple(lse.shape) == (8, 10)
    dq, dk, _ = fa.flash_attention_bwd(q, k, k, out, lse, out, causal=True)
    assert tuple(dq.shape) == (2, 4, 10, 32)
    assert tuple(dk.shape) == (2, 4, 12, 32)


# (B, H, Tq, Tk, D, causal, dtype, rows, keys, chunk): the sliced plain
# backward (dq of `rows`, dk/dv of `keys`, summed `chunk` at a time)
SLICED_CASES = [
    (1, 2, 70, 70, 32, True, "float32", (40, 70), (10, 30), 16),
    (1, 2, 90, 40, 16, True, "float32", (0, 90), (0, 40), 32),    # Tq > Tk
    (2, 2, 40, 100, 64, True, "float32", (5, 40), (60, 100), 24),  # Tq < Tk
    (1, 3, 37, 45, 128, False, "float32", (0, 37), (7, 45), 8),
    (1, 2, 70, 70, 32, True, "bfloat16", (40, 70), (10, 30), None),
    (1, 2, 90, 40, 64, True, "bfloat16", (50, 90), (0, 40), None),
    (2, 2, 40, 100, 128, False, "bfloat16", (0, 40), (60, 100), None),
]


def _bwd_torch_inputs(b, h, tq, tk, d, dtype, seed):
    q, k, v = _inputs(b, h, tq, tk, d, seed)
    do = np.random.RandomState(seed + 1).standard_normal(
        (b, h, tq, d)).astype(np.float32)
    return [torch.from_numpy(x).to(getattr(torch, dtype))
            for x in (q, k, v, do)]


@pytest.mark.parametrize("b,h,tq,tk,d,causal,dtype,rows,keys,chunk",
                         SLICED_CASES)
def test_sliced_plain_bwd_matches_full(b, h, tq, tk, d, causal, dtype, rows,
                                       keys, chunk):
    """The sliced plain backward (how phase 4 of chip_smoke.py checks the
    kernels at 32768 tokens) gives the full plain version's rows and keys:
    f32 within 1e-6 of the scale (the chunks add in another order), bf16
    exactly where it sums in one chunk, as the full version does."""
    q, k, v, do = _bwd_torch_inputs(b, h, tq, tk, d, dtype, seed=tq + tk)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    full = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    got = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                       rows=rows, keys=keys, chunk=chunk)
    want = (full[0][:, :, rows[0]:rows[1]], full[1][:, :, keys[0]:keys[1]],
            full[2][:, :, keys[0]:keys[1]])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if dtype == "bfloat16":
            assert torch.equal(g, w), name
        else:
            tol = 1e-6 * max(1.0, w.abs().max().item())
            assert (g - w).abs().max().item() <= tol, name
    if causal and tq > tk and rows[0] < tq - tk:
        assert (got[0][:, :, :tq - tk - rows[0]] == 0).all()


@pytest.mark.parametrize("b,h,tq,tk,d,causal,dtype,rows,keys,chunk",
                         SLICED_CASES)
def test_sliced_plain_bwd_matches_pallas_interpret_vjp(
        b, h, tq, tk, d, causal, dtype, rows, keys, chunk):
    """The same slices against jax.vjp of the JAX package's kernel in
    interpret mode, within the tolerances of the full comparison above
    (f32 1e-5, bf16 2e-2)."""
    q, k, v, do = _bwd_torch_inputs(b, h, tq, tk, d, "float32", seed=tq + tk)
    jq, jk, jv, jdo = (jnp.asarray(x.numpy(), dtype=dtype)
                       for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: flash_attention(
        a, b_, c, causal=causal, impl="interpret", block_q=16,
        block_k=16), jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)
    q, k, v, do = (x.to(getattr(torch, dtype)) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    got = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                       rows=rows, keys=keys, chunk=chunk)
    want = (to_numpy(jdq)[:, :, rows[0]:rows[1]],
            to_numpy(jdk)[:, :, keys[0]:keys[1]],
            to_numpy(jdv)[:, :, keys[0]:keys[1]])
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(to_numpy(g), w, rtol=tol, atol=tol,
                                   err_msg=name)


# (B, H, Tq, Tk, causal, dtype) at head dim 72, which the kernels take
# padded to 80
PAD_CASES = [(2, 2, 40, 56, True, "float32"), (1, 3, 37, 45, False, "float32"),
             (1, 2, 56, 24, True, "bfloat16")]
PAD_D = 72


@pytest.mark.parametrize("b,h,tq,tk,causal,dtype", PAD_CASES)
def test_head_dim_padding_matches_plain_and_jax(b, h, tq, tk, causal, dtype):
    """What the kernels' wrappers do at a head dim that is not a multiple
    of 16: q, k, v zero-padded along D (each pad counted as a copy), the
    scale of the unpadded D, the output's padded columns sliced off.  The
    padded plain forward gives the plain forward's out within 1e-6 of its
    scale (the sums over D take other orders; bf16: one bf16 step) and
    its lse within 1e-5; the plain forward equals
    the JAX package's flash_attention (impl "xla") at D 72 within 1e-5
    in f32 (2e-2 in bf16, P rounded at other points)."""
    q, k, v = _inputs(b, h, tq, tk, PAD_D, seed=tq + tk)
    tq_, tk_, tv_ = (torch.from_numpy(x).to(getattr(torch, dtype))
                     for x in (q, k, v))
    scale = 1.0 / math.sqrt(PAD_D)
    copies = fa.flash_attention_fwd.copies
    padded = [fa._pad_head(x, fa.flash_attention_fwd)
              for x in (tq_, tk_, tv_)]
    assert fa.flash_attention_fwd.copies == copies + 3
    assert all(x.shape[3] == 80 and x.is_contiguous() for x in padded)
    assert all(torch.equal(p[..., :PAD_D], x) and not p[..., PAD_D:].any()
               for p, x in zip(padded, (tq_, tk_, tv_)))
    out_p, lse_p = fa.flash_attention_fwd_plain(*padded, causal, scale)
    out, lse = fa.flash_attention_fwd_plain(tq_, tk_, tv_, causal, scale)
    got = fa._unpad_head(out_p, PAD_D)
    assert got.shape == out.shape and got.is_contiguous()
    rel = 1e-6 if dtype == "float32" else 2 ** -8
    assert (got.float() - out.float()).abs().max().item() <= rel * max(
        1.0, out.float().abs().max().item())
    assert (lse_p - lse).abs().max().item() <= 1e-5
    jout = flash_attention(*(jnp.asarray(x, dtype=dtype) for x in (q, k, v)),
                           causal=causal, impl="xla")
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(to_numpy(out), to_numpy(jout), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("b,h,tq,tk,causal,dtype", PAD_CASES)
def test_head_dim_padding_bwd_matches_plain_and_jax(b, h, tq, tk, causal,
                                                    dtype):
    """The backward's padding: q, k, v and dO padded along D, the padded
    plain backward's dq, dk, dv sliced back equal the unpadded plain
    backward's within 1e-6 of their scale (bf16: one bf16 step), and the
    plain backward equals jax.vjp of the JAX package's flash_attention
    (impl "xla") at D 72 within 1e-5 in f32 (2e-2 in bf16)."""
    q, k, v, do = _bwd_torch_inputs(b, h, tq, tk, PAD_D, dtype, seed=tq)
    scale = 1.0 / math.sqrt(PAD_D)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    copies = fa.flash_attention_bwd.copies
    padded = [fa._pad_head(x, fa.flash_attention_bwd) for x in (q, k, v, do)]
    assert fa.flash_attention_bwd.copies == copies + 4
    o_p = fa._pad_head(o, fa.flash_attention_bwd)
    got = fa.flash_attention_bwd_plain(*padded[:3], o_p, lse, padded[3],
                                       causal, scale)
    rel = 1e-6 if dtype == "float32" else 2 ** -7
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = fa._unpad_head(g, PAD_D)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        tol = rel * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol, name
    jargs = [jnp.asarray(x.float().numpy(), dtype=dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b_, c: flash_attention(
        a, b_, c, causal=causal, impl="xla"), *jargs)
    jgrads = vjp(jnp.asarray(do.float().numpy(), dtype=dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), want, jgrads):
        np.testing.assert_allclose(to_numpy(g), to_numpy(w), rtol=tol,
                                   atol=tol, err_msg=name)


# (B, H, Tq, Tk, causal, dtype) at head dim 160, which the kernels take
# in the wide tile
WIDE_CASES = [(1, 2, 40, 56, True, "float32"), (1, 2, 37, 45, False, "float32"),
              (1, 2, 56, 24, True, "bfloat16")]
WIDE_D = 160


@pytest.mark.parametrize("b,h,tq,tk,causal,dtype", WIDE_CASES)
def test_wide_head_dim_matches_jax(b, h, tq, tk, causal, dtype):
    """At D 160 (the wide tile's range) the plain forward equals the JAX
    package's flash_attention (impl "xla") within 1e-5 in f32 (2e-2 in
    bf16, P rounded at other points), and the plain backward equals
    jax.vjp of it within the same."""
    q, k, v, do = _bwd_torch_inputs(b, h, tq, tk, WIDE_D, dtype, seed=tq)
    scale = 1.0 / math.sqrt(WIDE_D)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
    jargs = [jnp.asarray(x.float().numpy(), dtype=dtype) for x in (q, k, v)]
    jout, vjp = jax.vjp(lambda a, b_, c: flash_attention(
        a, b_, c, causal=causal, impl="xla"), *jargs)
    jgrads = vjp(jnp.asarray(do.float().numpy(), dtype=dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(to_numpy(o), to_numpy(jout), rtol=tol,
                               atol=tol, err_msg="out")
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(to_numpy(g), to_numpy(w), rtol=tol,
                                   atol=tol, err_msg=name)


# (B, H, Tq, Tk, causal, dtype) at head dim 320, which the kernels take in
# the wide tile's 256-column slices
SLICED_D = 320


@pytest.mark.parametrize("b,h,tq,tk,causal,dtype", WIDE_CASES)
def test_head_dim_above_256_matches_jax(b, h, tq, tk, causal, dtype):
    """At D 320 (two 256-column slices on the card) the plain forward
    equals the JAX package's flash_attention (impl "xla") within 1e-5 in
    f32 (2e-2 in bf16, P rounded at other points), and the plain backward
    equals jax.vjp of it within the same."""
    q, k, v, do = _bwd_torch_inputs(b, h, tq, tk, SLICED_D, dtype, seed=tk)
    scale = 1.0 / math.sqrt(SLICED_D)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
    jargs = [jnp.asarray(x.float().numpy(), dtype=dtype) for x in (q, k, v)]
    jout, vjp = jax.vjp(lambda a, b_, c: flash_attention(
        a, b_, c, causal=causal, impl="xla"), *jargs)
    jgrads = vjp(jnp.asarray(do.float().numpy(), dtype=dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(to_numpy(o), to_numpy(jout), rtol=tol,
                               atol=tol, err_msg="out")
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(to_numpy(g), to_numpy(w), rtol=tol,
                                   atol=tol, err_msg=name)
