"""The port's flash_decode (paddle_tpu_torch/ops/flash_decode.py) on the
CPU: its plain version against the JAX package's Pallas kernel run
under the Pallas interpreter (``impl="interpret"``, as
tests/test_paged_decode.py runs it), the IR op, the dispatch rules and
the int8 accuracy bar.

Inputs are made with numpy from a seed and written into both packages'
paged caches by the same calls.  Tolerances: f32 within 1e-6 (the two
sum the same products in other orders), bf16 within one bf16 step of
the output (2^-8 relative; both round p and the output to bf16 at the
same points), int8 pools within 1e-6 (f32 arithmetic throughout).  The
CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_port_helpers import to_numpy

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops import paged_kv as jkv
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.ops.epilogue import greedy_logits_tail
from paddle_tpu_torch.ops.paged_kv import PagedKVCache

TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8, "int8": 1e-6}


def _setup(lens, r=1, H=2, d=64, ps=16, dtype="float32", seed=1):
    """Both packages' caches holding the same prefills, and q."""
    int8 = dtype == "int8"
    store = "float32" if int8 else dtype
    rng = np.random.RandomState(seed)
    kw = dict(num_pages=64, page_size=ps, num_heads=H, head_dim=d,
              kv_int8=int8)
    tc = PagedKVCache(dtype=getattr(torch, store), device="cpu", **kw)
    jc = jkv.PagedKVCache(dtype=getattr(jnp, store), **kw)
    for t in lens:
        k = rng.randn(t, H, d).astype(np.float32)
        v = rng.randn(t, H, d).astype(np.float32)
        tc.prefill(k, v)
        jc.prefill(k, v)
    shape = (len(lens), H, d) if r == 1 else (len(lens), r, H, d)
    qn = rng.randn(*shape).astype(np.float32)
    slots = list(range(len(lens)))
    port = (torch.from_numpy(qn).to(getattr(torch, store)), tc,
            tc.tables_for(slots), tc.lens_for(slots),
            tc.kv_scales() if int8 else None)
    jax_ = (jnp.asarray(qn).astype(getattr(jnp, store)), jc,
            jc.tables_for(slots), jc.lens_for(slots),
            jc.kv_scales() if int8 else None)
    return port, jax_


def _port_out(port, **kw):
    q, c, tab, ln, scales = port
    return fd.flash_decode(q, c.k_pages, c.v_pages, tab, ln,
                           kv_scales=scales, **kw)


def _assert_close(got, want, dtype):
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape
    tol = TOL[dtype] * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("r", [1, 5, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_matches_jax_interpret_kernel(d, dtype, r):
    """Ragged lengths spanning none, one and several page boundaries and
    a row shorter than the verify window."""
    ps = 32 if dtype == "int8" else 16     # the Pallas int8 page tile
    port, jx = _setup([5, 33, 16, 1], r=r, d=d, ps=ps, dtype=dtype)
    q, c, tab, ln, scales = jx
    # under one jit: the interpreted grid compiles once instead of
    # dispatching op by op (the result is the same, array_equal)
    want = jax.jit(lambda *a: pk.flash_decode(
        *a, impl="interpret", kv_scales=scales))(q, c.k_pages, c.v_pages,
                                                   tab, ln)
    got = _port_out(port)          # a CPU tensor: the plain version
    assert got.dtype == port[0].dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d,r,lens", [(72, 5, [5, 33, 16, 1]),
                                      (160, 5, [5, 33, 16, 1]),
                                      (64, 70, [100, 75, 70, 5]),
                                      (1536, 5, [5, 33, 16, 1])])
def test_plain_matches_jax_interpret_kernel_any_d_and_rows(d, r, lens,
                                                          dtype):
    """Head dims off the old kernel's range (72, 160, 1536) and 70 verify
    rows, which the kernel now takes: the plain version still equals the JAX
    package's kernel under the interpreter, within TOL."""
    ps = 32 if dtype == "int8" else 16     # the Pallas int8 page tile
    port, jx = _setup(lens, r=r, d=d, ps=ps, dtype=dtype)
    q, c, tab, ln, scales = jx
    want = jax.jit(lambda *a: pk.flash_decode(
        *a, impl="interpret", kv_scales=scales))(q, c.k_pages, c.v_pages,
                                                   tab, ln)
    got = _port_out(port)
    assert got.dtype == port[0].dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("r", [1, 5])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_plain_matches_jax_interpret_kernel_above_d_2048(dtype, r):
    """d 3072, which the kernel takes on its wide path (above 2048): the
    plain version still equals the JAX package's kernel under the
    interpreter, within TOL, over f32 and int8 pools."""
    ps = 32 if dtype == "int8" else 16     # the Pallas int8 page tile
    port, jx = _setup([5, 33, 16, 1], r=r, d=3072, ps=ps, dtype=dtype)
    q, c, tab, ln, scales = jx
    want = jax.jit(lambda *a: pk.flash_decode(
        *a, impl="interpret", kv_scales=scales))(q, c.k_pages, c.v_pages,
                                                   tab, ln)
    got = _port_out(port)
    assert got.dtype == port[0].dtype
    _assert_close(got, want, dtype)


def test_plain_matches_plain_softmax():
    """The page-ordered online softmax equals softmax(QK^T)V over the
    live prefix (within 1e-5 of outputs of unit scale)."""
    lens = [5, 33, 16]
    port, _ = _setup(lens, H=4, d=64)
    out = _port_out(port).numpy()
    rng = np.random.RandomState(1)
    for i, t in enumerate(lens):
        k = rng.randn(t, 4, 64).astype(np.float32)
        v = rng.randn(t, 4, 64).astype(np.float32)
        s = np.einsum("hd,thd->ht", port[0][i].numpy(), k) / 8.0
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        assert np.allclose(out[i], np.einsum("ht,thd->hd", p, v),
                           atol=1e-5)


def test_verify_rows_match_qlen1_calls():
    """Verify row r equals a q-len-1 call at length len - R + 1 + r (to
    1e-6 here; bit-equal on the card, tests/test_torch_cuda.py)."""
    port, _ = _setup([9, 33, 17], r=4, H=2, d=64)
    q, c, tab, ln, _ = port
    out = fd.flash_decode(q, c.k_pages, c.v_pages, tab, ln)
    for r in range(4):
        one = fd.flash_decode(q[:, r].contiguous(), c.k_pages, c.v_pages,
                              tab, ln - (4 - 1 - r))
        _assert_close(one, out[:, r], "float32")


def test_zero_length_rows_emit_exact_zeros():
    port, _ = _setup([5], d=64)
    q, c, _, _, _ = port
    tab, ln = c.tables_for([0], pad_to=3), c.lens_for([0], pad_to=3)
    q3 = torch.cat([q, q[:1], q[:1]])
    out = fd.flash_decode(q3, c.k_pages, c.v_pages, tab, ln)
    assert torch.equal(out[1:], torch.zeros_like(out[1:]))
    assert out[0].abs().sum() > 0


def test_int8_needs_scales():
    port, _ = _setup([5], ps=32, dtype="int8")
    q, c, tab, ln, _ = port
    with pytest.raises(ValueError, match="kv_scales"):
        fd.flash_decode(q, c.k_pages, c.v_pages, tab, ln)


def test_dispatch_by_device_and_impl():
    port, _ = _setup([5, 9], d=64)
    q, c, tab, ln, _ = port
    base = fd.flash_decode(q, c.k_pages, c.v_pages, tab, ln)
    for impl in ("xla", "interpret"):
        assert torch.equal(base, fd.flash_decode(q, c.k_pages, c.v_pages,
                                                 tab, ln, impl=impl))
    # the kernel is chosen by q's device alone: no impl asks for it
    for impl in ("pallas", "mosaic"):
        with pytest.raises(ValueError, match="unknown impl"):
            fd.flash_decode(q, c.k_pages, c.v_pages, tab, ln, impl=impl)
    meta = fd.flash_decode(q.to("meta"), c.k_pages.to("meta"),
                           c.v_pages.to("meta"), tab.to("meta"),
                           ln.to("meta"))
    assert meta.shape == q.shape and meta.device.type == "meta"


@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_op_matches_jax_op(int8):
    from paddle_tpu.core.registry import get_op_def as jax_op_def

    dtype = "int8" if int8 else "float32"
    port, jx = _setup([7, 20], r=3, d=64, ps=32, dtype=dtype)
    ins = {}
    for pkg, (q, c, tab, ln, scales) in (("port", port), ("jax", jx)):
        ins[pkg] = {"Q": q, "KPages": c.k_pages, "VPages": c.v_pages,
                    "BlockTables": tab, "SeqLens": ln}
        if int8:
            ins[pkg].update(KScale=scales[0], VScale=scales[1])
    attrs = {"scale": 0.1}
    got = get_op_def("flash_decode").compute(ins["port"], attrs,
                                             torch.device("cpu"))["Out"]
    want = jax_op_def("flash_decode").compute(ins["jax"], attrs)["Out"]
    _assert_close(got, want, dtype)
    assert get_op_def("flash_decode").optional == {"KScale", "VScale"}


def test_int8_kv_top1_agreement():
    """Greedy next-token agreement between f32 and int8 pools over
    seeded ragged prompts holds >= 0.95, the JAX package's bar."""
    from paddle_tpu_torch.serving import TinyDecodeLM

    model = TinyDecodeLM(vocab=128, d_model=64, num_heads=4, head_dim=16,
                         seed=0, device="cpu")
    rng = np.random.RandomState(42)
    n, agree = 64, 0
    for _ in range(n):
        prompt = rng.randint(2, 128, size=int(rng.randint(2, 24)))
        _, k, v = model.qkv(prompt)
        tok = {}
        for int8 in (False, True):
            c = PagedKVCache(num_pages=8, page_size=16, num_heads=4,
                             head_dim=16, kv_int8=int8, device="cpu")
            s = c.prefill(k, v)
            q, _, _ = model.qkv(prompt[-1:])
            o = fd.flash_decode(q, c.k_pages, c.v_pages, c.tables_for([s]),
                                c.lens_for([s]),
                                kv_scales=c.kv_scales() if int8 else None)
            tok[int8] = int(greedy_logits_tail(model.logits(o))[0])
        agree += tok[False] == tok[True]
    assert agree / n >= 0.95, "int8-KV top-1 agreement %d/%d" % (agree, n)


def test_greedy_logits_tail_takes_the_first_maximum():
    from paddle_tpu.ops.epilogue import greedy_logits_tail as jax_tail

    x = np.random.RandomState(3).randn(6, 11).astype(np.float32)
    x[2, [1, 7]] = 9.0                           # a tie
    x[4, :] = 0.0
    got = greedy_logits_tail(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jax_tail(jnp.asarray(x))))
    assert got[2] == 1 and got[4] == 0
