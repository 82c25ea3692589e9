"""The port's hand-written CUDA kernels on a card.

This file imports no JAX, so it also runs where only PyTorch is
installed.  On a card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The ``cuda``-marked tests skip where there is no CUDA device: a CUDA
kernel has no CPU mode.  The forward kernel is held against its plain
PyTorch version: f32 within 1e-4 (other summation order), bf16 ``out``
within 3e-2 (P is rounded to bf16 before P.V), ``lse`` within 1e-3.  The
backward kernels are held against ``flash_attention_bwd_plain`` within
``1e-4 * max(1, max|ref|)`` in f32 and ``3e-2 * max(1, max|ref|)`` in
bf16 (dS rounded to bf16 in both, at other points of the sum), over
every head dim, ragged and one-key lengths, strided and misaligned
views (the latter copied and counted); two launches give the same bits,
the bf16 dV is nearer the plain version than dV with P rounded to bf16
is (P stays f32, as in the Pallas kernel), and the f32 grads and the f32
forward's out and lse (split TF32) are at least 10x nearer the plain
version than the plain version on TF32-rounded inputs is.  Head dims
that are not multiples of 16 (8, 40, 72) run padded, forward and
backward, with their copies counted.  A
training step of the tiny LM on the card matches the CPU within
rtol=atol=1e-4 in the loss and every parameter grad.

The ``fc_epilogue`` kernel is held against ``fc_epilogue_plain`` over
every fc stage subset, ragged shapes (the mma.sync path) and aligned
ones (the wgmma path, each call counted on its path), f32 and bf16; the
AMP step's three shapes take the wgmma path, misaligned operands the
mma.sync one, two launches give the same bits, and more than 65,535 row
tiles run on every path.  Both
accumulate the same products in f32 in other orders (f32 within 1e-4 of
outputs of unit scale); bf16 output is one rounding of that f32 value,
so the two may differ by one bf16 step where the sums straddle a
rounding boundary (within 1e-2 + 1e-2 * |ref|).

The conv kernels (``conv_epilogue``, ``conv_stats``) are held against
their plain versions in the same way, over every conv stage subset with
bias and residual in either dtype, 1x1/3x3/5x5/7x7 filters, strides 1
and 2, Cin 3, 4, 16 and 24, every bf16 tile shape, ragged Cout and M,
and misaligned views; the statistics' mean and var within 1e-4 (f32)
and 1e-3 (bf16: y itself may sit one bf16 step apart) of their scale,
and two launches give the same bits.  ``bn_apply`` rounds at the
plain version's points with no fused multiply-add, so it is held within
1e-6 of the scale in f32 and one bf16 step in bf16.  TF32 is off for
cuDNN as well.

``flash_decode`` is held against ``flash_decode_plain`` over ragged
lengths (zero-length rows among them), page sizes 4 to 128, strided
block tables, d 16 to 4096 (above 2048 the wide kernel), 1 to 70
query rows and f32, bf16 and int8
pools: within ``1e-5 * max(1, max|ref|)`` in f32 and over int8 pools
(f32 sums in another order) and one bf16 step in bf16.  Its verify rows
are array_equal to q-len-1 launches, and a small decode server on the
card emits the CPU server's tokens.

``CompiledProgram`` on the card: a small program compiled (the eager
warm-up, then replays of its CUDA graph) equals the interpreted runs
bitwise, fetches and persistables, with the replays' launches equal to
the interpreted ones and the persistables at fixed addresses; a
replayed step equals an eager step from the same state; an op that
synchronises the card fails the warm-up or the capture, and ``run``
raises (nothing falls back); a second feed shape captures a second
graph; two CompiledPrograms in two threads, one warming up and capturing
new keys while the other replays in a loop, give the serial runs' bits
with no error (the per-device lock of the compiled path).

``conv_int8`` (the s8 convolution of ``conv2d_int8`` and ``mul_int8``) is
``torch.equal`` to ``conv_int8_plain`` over odd Cin and Cout, the
3-channel and 1-channel stems (packed), 1x1 (by TMA and gathered), stride
2, dilation 2, groups 2 and 4 (the mma.sync route), Cout 64, 128, 256 and
512 (each wgmma tile width), M off the tiles, an fc shape and every
epilogue subset (int32 out; f32 or bf16 out with bias and residual in
either dtype, relu, OutScale): the int32 sum is exact and every float
step is fixed, so anything short of equal is a fault.  Each shape's route
is counted and gives the mma.sync kernel's bits.  A misaligned view is
copied (counted) and gives the same bits, two launches give the same
bits, and the two ops on a CUDA tensor give the CPU op's bits.
``quantize_act`` is ``torch.equal`` to its plain version at odd sizes,
over f32 and bf16, ties and saturation, and views off 16 bytes,
permuted or strided.

The bench's other training legs at small sizes: a 2-layer BERT and a
DeepFM of hidden (32, 32) take two f32 Adam steps on the card within
1e-4 of the CPU (BERT launching 2/1/1 flash kernels a layer a step,
DeepFM none), and three compiled steps give the interpreter's bits; the
long-context program (2 heads of 512 tokens, d 64 and 128) launches
2/1/1 a step and its fetches, interpreted and compiled, are
``torch.equal`` to a direct call of the flash autograd Function.
"""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_LM, fresh_port_programs

from paddle_tpu_torch.ops import conv_epilogue as cep
from paddle_tpu_torch.ops import epilogue as ep
from paddle_tpu_torch.ops import flash_attention as fa

# (B, H, Tq, Tk, D, causal, dtype)
CASES = [
    (1, 2, 40, 40, 32, True, "float32"),
    (2, 2, 24, 56, 16, True, "float32"),      # Tq < Tk, bottom-right
    (1, 2, 56, 24, 16, True, "float32"),      # Tq > Tk: fully masked rows
    (1, 3, 37, 45, 32, False, "float32"),     # ragged T
    (2, 2, 130, 130, 128, False, "float32"),
    (2, 8, 512, 512, 64, True, "float32"),
    # the f32 kernel (split TF32) at the other head dims (64-key tiles up
    # to D 80, 32 above, Q split per tile at 128), causal and not, Tk off
    # the key tile and Tq off the 128-row tile, several tiles on both sides
    (1, 2, 200, 200, 48, True, "float32"),
    (2, 2, 130, 190, 80, False, "float32"),
    (1, 3, 300, 300, 96, True, "float32"),
    (1, 2, 129, 257, 112, True, "float32"),
    (1, 2, 256, 256, 128, True, "float32"),
    (1, 2, 200, 70, 64, True, "float32"),     # Tq > Tk: fully masked rows
    (1, 2, 150, 40, 128, True, "float32"),    # the same at d 128
    (1, 2, 48, 48, 32, True, "bfloat16"),
    (1, 2, 37, 61, 16, True, "bfloat16"),
    # the tensor-core path at every head dim it takes, causal and not,
    # with Tk off the 64-key tile and Tq off the 128-row tile
    (1, 2, 200, 200, 16, True, "bfloat16"),
    (2, 2, 130, 190, 48, False, "bfloat16"),
    (1, 3, 300, 300, 64, True, "bfloat16"),
    (1, 2, 77, 141, 80, True, "bfloat16"),
    (1, 2, 150, 150, 96, False, "bfloat16"),
    (1, 2, 129, 257, 112, True, "bfloat16"),
    (1, 2, 256, 256, 128, True, "bfloat16"),
    (1, 2, 200, 70, 64, True, "bfloat16"),    # Tq > Tk: fully masked rows
    (1, 2, 150, 40, 128, True, "bfloat16"),   # the same at d 128
    (2, 2, 100, 97, 64, False, "bfloat16"),   # ragged T
    # the wide tile (128 < D <= 256): causal and not, Tq > Tk (fully
    # masked rows), Tk off the 32-key tile and Tq off the 16-row tile
    (1, 2, 200, 200, 160, True, "float32"),
    (2, 2, 130, 190, 256, False, "float32"),
    (1, 2, 150, 40, 256, True, "float32"),
    (1, 2, 200, 200, 160, True, "bfloat16"),
    (1, 2, 129, 257, 256, True, "bfloat16"),
    (1, 2, 150, 40, 160, True, "bfloat16"),
    # above 256: S over D in 256-column slices, one CTA a 256-column slice
    # of O (a last slice of 64, 16 and 256), causal and not, several K/V
    # tiles (Tk >= 200), Tq > Tk
    (1, 2, 150, 230, 320, True, "float32"),
    (2, 2, 130, 210, 512, False, "float32"),
    (1, 2, 250, 200, 264, True, "float32"),
    (1, 2, 200, 230, 320, False, "bfloat16"),
    (1, 2, 129, 257, 512, True, "bfloat16"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    mm = torch.backends.cuda.matmul
    old = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
           torch.backends.cudnn.allow_tf32)
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tq,tk,d,causal,dtype", CASES)
def test_flash_kernel_matches_plain(cuda, b, h, tq, tk, d, causal, dtype):
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                .astype(np.float32))
               .to(cuda, getattr(torch, dtype)) for t in (tq, tk, tk))
    launches = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == launches + 1
    ref_out, ref_lse = fa.flash_attention_fwd_plain(
        q, k, v, causal, 1.0 / math.sqrt(d))
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    if causal and tq > tk:
        assert (out[:, :, :tq - tk] == 0).all()
        assert (lse.reshape(b, h, tq)[:, :, :tq - tk] == -1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "unaligned"])
def test_flash_kernel_takes_views(cuda, layout):
    """bf16 q/k/v as views: permuted [B,T,H,D] tensors (the model's
    layout, 16-byte aligned rows, no copy), and views whose rows start
    2 bytes into a 16-byte chunk, which the wrapper copies (counted)."""
    b, h, tq, tk, d = 2, 4, 150, 150, 64
    rng = np.random.RandomState(3)

    def view(t):
        if layout == "strided":
            x = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
                np.float32)).to(cuda, torch.bfloat16)
            return x.permute(0, 2, 1, 3)
        x = torch.from_numpy(rng.standard_normal((b, h, t, d + 8)).astype(
            np.float32)).to(cuda, torch.bfloat16)
        return x[..., 1:d + 1]

    q, k, v = view(tq), view(tk), view(tk)
    copies = fa.flash_attention_fwd.copies
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.copies == copies + (
        3 if layout == "unaligned" else 0)
    ref_out, ref_lse = fa.flash_attention_fwd_plain(
        q, k, v, True, 1.0 / math.sqrt(d))
    assert out.is_contiguous()
    assert (out.float() - ref_out.float()).abs().max().item() <= 3e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "unaligned"])
def test_flash_f32_kernel_takes_views(cuda, layout):
    """f32 q/k/v as views: permuted [B,T,H,D] tensors (the model's layout,
    no copy), and views whose rows start 4 bytes into a 16-byte chunk,
    which the wrapper copies (counted) for the kernel's 16-byte copies."""
    b, h, tq, tk, d = 2, 4, 150, 150, 64
    rng = np.random.RandomState(3)

    def view(t):
        if layout == "strided":
            x = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
                np.float32)).to(cuda)
            return x.permute(0, 2, 1, 3)
        x = torch.from_numpy(rng.standard_normal((b, h, t, d + 4)).astype(
            np.float32)).to(cuda)
        return x[..., 1:d + 1]

    q, k, v = view(tq), view(tk), view(tk)
    copies = fa.flash_attention_fwd.copies
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.copies == copies + (
        3 if layout == "unaligned" else 0)
    ref_out, ref_lse = fa.flash_attention_fwd_plain(
        q, k, v, True, 1.0 / math.sqrt(d))
    assert out.is_contiguous()
    assert (out - ref_out).abs().max().item() <= 1e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def _tf32_fwd(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.cuda
def test_flash_fwd_f32_is_not_single_pass_tf32(cuda):
    """The f32 forward's products are split TF32, three TF32 products on
    each operand's high and low halves (about 21 bits of each), not one
    TF32 product (about 11): its out and lse are at least 10x nearer the
    plain version than the plain version on TF32-rounded q, k and v is."""
    b, h, t, d = 2, 4, 300, 64
    rng = np.random.RandomState(7)
    q, k, v, _ = _bwd_inputs(rng, cuda, b, h, t, t, d, "float32", True)
    scale = 1.0 / math.sqrt(d)
    got = fa.flash_attention_fwd(q, k, v, True, scale)
    want = fa.flash_attention_fwd_plain(q, k, v, True, scale)
    tf32 = fa.flash_attention_fwd_plain(_tf32_fwd(q), _tf32_fwd(k),
                                        _tf32_fwd(v), True, scale)
    for name, g, w, r in zip(("out", "lse"), got, want, tf32):
        err = (g - w).norm().item()
        err_tf32 = (r - w).norm().item()
        assert 10 * err <= err_tf32, (name, err, err_tf32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 40, 72])
def test_flash_kernels_take_any_head_dim(cuda, d, dtype):
    """A head dim that is not a multiple of 16 runs on the card: the
    wrappers pad q, k, v (and dO) with zero columns to the next multiple
    of 16 (3 and 4 counted copies), keep the scale of the unpadded D and
    slice the outputs back; forward and backward agree with the plain
    versions at the usual tolerances."""
    b, h, tq, tk = 1, 2, 150, 170
    rng = np.random.RandomState(d)
    q, k, v, do = _bwd_inputs(rng, cuda, b, h, tq, tk, d, dtype, True)
    scale = 1.0 / math.sqrt(d)
    copies = fa.flash_attention_fwd.copies
    out, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.copies == copies + 3
    assert out.shape == q.shape and out.is_contiguous()
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, True, scale)
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    copies = fa.flash_attention_bwd.copies
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, True, scale)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.copies == copies + 4
    refs = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, True, scale)
    rel = 1e-4 if dtype == "float32" else 3e-2
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert g.is_contiguous(), name
        err = (g.float() - r.float()).abs().max().item()
        assert err <= rel * max(1.0, r.float().abs().max().item()), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [160, 256, 320, 512])
def test_flash_kernels_take_wide_and_strided_head_dims(cuda, d, dtype):
    """Head dims above 128 run the wide tile, forward and backward, each
    kernel launched once and counted, with no copy of contiguous inputs;
    a head dim with a non-unit stride (a transposed [..., D, T] tensor)
    is copied once per input, each copy counted, and gives the same
    forward (the backward's delta, rowsum(dO * O), is a PyTorch sum whose
    order follows dO's layout, so its grads are held to the plain
    version only)."""
    b, h, tq, tk = 1, 2, 150, 170
    rng = np.random.RandomState(d)
    q, k, v, do = _bwd_inputs(rng, cuda, b, h, tq, tk, d, dtype, False)
    scale = 1.0 / math.sqrt(d)
    tol = 1e-4 if dtype == "float32" else 3e-2
    refs = None
    for layout in ("contiguous", "strided_head"):
        if layout == "strided_head":
            q, k, v, do = (x.transpose(2, 3).contiguous().transpose(2, 3)
                           for x in (q, k, v, do))
            assert q.stride(3) != 1
        copies, bcopies = fa.flash_attention_fwd.copies, \
            fa.flash_attention_bwd.copies
        launches = fa.flash_attention_fwd.launches
        dq_l, dkv_l = (fa.flash_attention_bwd.launches[n]
                       for n in ("dq", "dkv"))
        out, lse = fa.flash_attention_fwd(q, k, v, True, scale)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, True, scale)
        torch.cuda.synchronize()
        assert fa.flash_attention_fwd.launches == launches + 1
        assert fa.flash_attention_bwd.launches["dq"] == dq_l + 1
        assert fa.flash_attention_bwd.launches["dkv"] == dkv_l + 1
        strided = layout == "strided_head"
        assert fa.flash_attention_fwd.copies == copies + 3 * strided
        assert fa.flash_attention_bwd.copies == bcopies + 4 * strided
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, True,
                                                        scale)
        assert (out.float() - ref_out.float()).abs().max().item() <= tol
        assert (lse - ref_lse).abs().max().item() <= 1e-3
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, True,
                                            scale)
        for name, g, r in zip(("dq", "dk", "dv"), grads, want):
            assert g.is_contiguous() and g.dtype == r.dtype, name
            err = (g.float() - r.float()).abs().max().item()
            assert err <= tol * max(1.0, r.float().abs().max().item()), name
        if refs is None:
            refs = (out, lse)
        else:
            assert torch.equal(refs[0], out) and torch.equal(refs[1], lse)


# the f64 hold's bounds (test_flash_f32_kernels_hold_against_f64)
F64_MAX_FACTOR = 4.0
F64_BIAS_FACTOR = 4.0
F64_BIAS_FLOOR = 1e-7


def _f64_attention(q, k, v, do, scale):
    """Causal attention's out, dq, dk, dv in f64 by autograd."""
    tq, tk = q.shape[2], k.shape[2]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(
        tk - tq)
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    s = torch.matmul(leaves[0], leaves[1].transpose(-1, -2)) * scale
    out = torch.matmul(torch.softmax(s.masked_fill(~mask, float("-inf")),
                                     dim=-1), leaves[2])
    return (out.detach(), *torch.autograd.grad(out, leaves, do.double()))


def _f64_errs(got, ref):
    diff = got.double() - ref
    return (diff * torch.sign(ref)).mean().item(), diff.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8, 512, 64), (1, 2, 4096, 64),
                                   (1, 2, 512, 320)])
def test_flash_f32_kernels_hold_against_f64(cuda, shape):
    """The f32 kernels' out, dq, dk and dv against an f64 reference, beside
    the plain f32 version (cuBLAS, TF32 off) against the same reference:
    the kernels' max error within F64_MAX_FACTOR of the plain version's,
    and their mean signed error (signed by the reference, so a bias
    toward zero, which long chains of truncating tensor-core sums give,
    reads negative) within F64_BIAS_FACTOR of the plain version's
    magnitude, or of F64_BIAS_FLOOR of the reference's mean magnitude."""
    rng = np.random.RandomState(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda) for _ in range(4))
    scale = 1.0 / math.sqrt(shape[-1])
    refs = _f64_attention(q, k, v, do, scale)
    out, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, True, scale)
    got = (out, *fa.flash_attention_bwd(q, k, v, out, lse, do, True, scale))
    plain = (out_p, *fa.flash_attention_bwd_plain(q, k, v, out_p, lse_p, do,
                                                  True, scale))
    for name, g, pl, r in zip(("out", "dq", "dk", "dv"), got, plain, refs):
        bias, err = _f64_errs(g, r)
        pbias, perr = _f64_errs(pl, r)
        floor = F64_BIAS_FLOOR * r.abs().mean().item()
        assert err <= F64_MAX_FACTOR * perr, (name, err, perr)
        assert abs(bias) <= max(F64_BIAS_FACTOR * abs(pbias), floor), \
            (name, bias, pbias, floor)


@pytest.mark.cuda
def test_gpu_predictor_matches_cpu(cuda, tmp_path):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    with fresh_port_programs():
        model = transformer_encoder_model(**TINY_LM)
        exe = pt.Executor()
        np.random.seed(0)
        exe.run(pt.default_startup_program())
        pt.io.save_inference_model(str(tmp_path), ["src_ids"],
                                   [model["logits"]], exe)
    gpu = pt.inference.create_predictor(pt.inference.Config(str(tmp_path)))
    cfg = pt.inference.Config(str(tmp_path))
    cfg.disable_gpu()
    cpu = pt.inference.create_predictor(cfg)
    ids = np.random.RandomState(2).randint(
        0, TINY_LM["vocab_size"], (2, TINY_LM["max_len"], 1))
    # the first request runs the plan eagerly, then captures it (each
    # launching n_layer times from Python); a second one replays
    launches = fa.flash_attention_fwd.launches
    out, = gpu.run([ids.astype(np.int64)])
    n = TINY_LM["n_layer"]
    assert fa.flash_attention_fwd.launches == launches + 2 * n
    again, = gpu.run([ids.astype(np.int64)])
    assert fa.flash_attention_fwd.launches == launches + 2 * n
    assert gpu._compiled.replayed_launches()["flash_attention_fwd"] == n
    np.testing.assert_array_equal(again, out)
    ref, = cpu.run([ids.astype(np.int64)])
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


# (B, H, Tq, Tk, D, causal, dtype, strided, with_dlse)
BWD_CASES = [
    (1, 2, 40, 40, 32, True, "float32", False, False),
    (1, 2, 40, 40, 32, False, "float32", False, False),
    (2, 2, 24, 56, 16, True, "float32", False, False),   # Tq < Tk
    (1, 2, 56, 24, 16, True, "float32", False, False),   # fully masked rows
    (1, 3, 37, 45, 32, False, "float32", True, False),   # ragged, strided
    (2, 2, 130, 130, 128, False, "float32", False, True),
    (2, 8, 512, 512, 64, True, "float32", True, False),
    (1, 2, 20, 1, 32, True, "float32", False, False),    # one key
    # the f32 kernels (split TF32) at the other head dims, several tiles
    # on both sides, and non-square at 16, 48 and 128, whose products
    # permute k on both sides
    (1, 2, 77, 141, 48, True, "float32", False, True),   # Tq < Tk, dlse
    (1, 2, 150, 150, 80, False, "float32", True, False),  # strided
    (1, 2, 129, 257, 96, True, "float32", False, False),
    (1, 2, 260, 100, 112, True, "float32", False, False),  # fully masked
    (1, 2, 150, 40, 128, True, "float32", True, False),  # the same, d 128
    (1, 2, 48, 48, 32, True, "bfloat16", False, False),
    (1, 2, 37, 61, 16, True, "bfloat16", True, True),
    # the tensor-core kernels at every head dim they take, causal and
    # not, Tq and Tk off the 64- and 128-row tiles, with several tiles
    # on both sides
    (1, 2, 200, 200, 16, True, "bfloat16", False, False),
    (2, 2, 130, 190, 32, False, "bfloat16", True, False),
    (1, 2, 77, 141, 48, True, "bfloat16", False, True),  # Tq < Tk, dlse
    (1, 3, 300, 300, 64, True, "bfloat16", True, False),
    (1, 2, 150, 150, 80, False, "bfloat16", False, False),
    (1, 2, 129, 257, 96, True, "bfloat16", False, False),
    (1, 2, 260, 100, 112, True, "bfloat16", True, False),  # Tq > Tk
    (1, 2, 256, 256, 128, True, "bfloat16", False, True),
    (1, 2, 200, 70, 64, True, "bfloat16", False, False),  # fully masked
    (1, 2, 150, 40, 128, True, "bfloat16", True, False),  # the same, d 128
    (2, 2, 100, 97, 64, False, "bfloat16", False, False),  # ragged T
    (1, 2, 33, 1, 64, False, "bfloat16", False, False),   # one key
    (1, 2, 33, 1, 128, True, "bfloat16", False, False),   # one key, causal
    (4, 8, 512, 512, 64, True, "bfloat16", True, False),  # the AMP layout
    # the wide tile: causal and not, ragged, fully masked rows, one key
    (1, 2, 200, 200, 160, True, "float32", False, True),
    (2, 2, 130, 190, 256, False, "float32", True, False),
    (1, 2, 150, 40, 256, True, "float32", False, False),
    (1, 2, 200, 200, 160, True, "bfloat16", True, False),
    (1, 2, 129, 257, 256, True, "bfloat16", False, True),
    (1, 2, 33, 1, 160, True, "bfloat16", False, False),
    # above 256 (256-column slices): causal and not, Tk >= 200, ragged,
    # strided, dlse, fully masked rows
    (1, 2, 150, 230, 320, True, "float32", False, True),
    (2, 2, 130, 210, 512, False, "float32", True, False),
    (1, 2, 250, 200, 264, True, "float32", False, False),
    (1, 2, 200, 230, 320, False, "bfloat16", True, False),
    (1, 2, 129, 257, 512, True, "bfloat16", False, True),
]


def _bwd_inputs(rng, device, b, h, tq, tk, d, dtype, strided):
    def make(t):
        x = torch.from_numpy(rng.standard_normal((b, t, h, d))
                             .astype(np.float32))
        x = x.to(device, getattr(torch, dtype)).permute(0, 2, 1, 3)
        return x if strided else x.contiguous()

    return make(tq), make(tk), make(tk), make(tq)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tq,tk,d,causal,dtype,strided,with_dlse",
                         BWD_CASES)
def test_flash_bwd_kernels_match_plain(cuda, b, h, tq, tk, d, causal,
                                       dtype, strided, with_dlse):
    rng = np.random.RandomState(2)
    q, k, v, do = _bwd_inputs(rng, cuda, b, h, tq, tk, d, dtype, strided)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    dlse = None
    if with_dlse:
        dlse = torch.from_numpy(rng.standard_normal((b * h, tq))
                                .astype(np.float32)).to(cuda)
    before = dict(fa.flash_attention_bwd.launches)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale, dlse)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == {
        "dq": before["dq"] + 1, "dkv": before["dkv"] + 1}
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                        dlse)
    rel = 1e-4 if dtype == "float32" else 3e-2
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert g.float().isfinite().all(), name
        tol = rel * max(1.0, r.float().abs().max().item())
        err = (g.float() - r.float()).abs().max().item()
        assert err <= tol, (name, err, tol)
    if causal and tq > tk:
        assert (grads[0][:, :, :tq - tk] == 0).all()   # rows that see no key


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "unaligned"])
def test_flash_bwd_kernels_take_views(cuda, layout):
    """bf16 q/k/v/dO as views: permuted [B,T,H,D] tensors (aligned, no
    copy), and views whose rows start 2 bytes into a 16-byte chunk, which
    the backward copies (counted in flash_attention_bwd.copies)."""
    b, h, tq, tk, d = 2, 4, 150, 170, 64
    rng = np.random.RandomState(4)

    def view(t):
        if layout == "strided":
            x = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
                np.float32)).to(cuda, torch.bfloat16)
            return x.permute(0, 2, 1, 3)
        x = torch.from_numpy(rng.standard_normal((b, h, t, d + 8)).astype(
            np.float32)).to(cuda, torch.bfloat16)
        return x[..., 1:d + 1]

    q, k, v, do = view(tq), view(tk), view(tk), view(tq)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    copies = fa.flash_attention_bwd.copies
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.copies == copies + (
        4 if layout == "unaligned" else 0)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True,
                                        1.0 / math.sqrt(d))
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.is_contiguous(), name
        tol = 3e-2 * max(1.0, r.float().abs().max().item())
        assert (g.float() - r.float()).abs().max().item() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 64), ("bfloat16", 128),
                                     ("float32", 64), ("float32", 128)])
def test_flash_bwd_kernels_are_deterministic(cuda, dtype, d):
    """No atomics: two launches on the same inputs give the same bits."""
    rng = np.random.RandomState(5)
    q, k, v, do = _bwd_inputs(rng, cuda, 2, 4, 300, 300, d, dtype, True)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_bwd_keeps_p_in_f32_for_dv(cuda):
    """dV = P^T dO with P in f32, as the Pallas kernel keeps it: at the
    AMP training shape the kernel's dV is nearer the plain version than
    the same product with P rounded to bf16 (FlashAttention-2's
    convention) is."""
    b, h, t, d = 32, 8, 512, 64
    rng = np.random.RandomState(6)
    q, k, v, do = _bwd_inputs(rng, cuda, b, h, t, t, d, "bfloat16", True)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    _, _, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, True, scale)
    _, _, want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True,
                                              scale)
    p, _ = fa._bwd_block(q, k, v, do, lse.reshape(b, h, t),
                         fa._delta(o, do, None).reshape(b, h, t), (0, t),
                         (0, t), True, scale)
    rounded = torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2),
                           do.float()).to(torch.bfloat16)
    err = (dv.float() - want.float()).norm().item()
    err_rounded = (rounded.float() - want.float()).norm().item()
    assert err < err_rounded, (err, err_rounded)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna rounds: half a TF32 step added to the magnitude's
    bits, then the 13 bits below it cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.cuda
def test_flash_bwd_f32_is_not_single_pass_tf32(cuda):
    """The f32 kernels' products are split TF32, three TF32 products on
    each operand's high and low halves (about 21 bits of each), not one
    TF32 product (about 11): their dq, dk and dv are at least 10x nearer
    the plain version than the plain version on TF32-rounded q, k, v and
    dO is."""
    b, h, t, d = 2, 4, 300, 64
    rng = np.random.RandomState(7)
    q, k, v, do = _bwd_inputs(rng, cuda, b, h, t, t, d, "float32", True)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True, scale)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True, scale)
    tf32 = fa.flash_attention_bwd_plain(_tf32(q), _tf32(k), _tf32(v), o,
                                        lse, _tf32(do), True, scale)
    for name, g, w, r in zip(("dq", "dk", "dv"), got, want, tf32):
        err = (g - w).norm().item()
        err_tf32 = (r - w).norm().item()
        assert 10 * err <= err_tf32, (name, err, err_tf32)


@pytest.mark.cuda
def test_flash_autograd_matches_grad_of_plain_forward(cuda):
    rng = np.random.RandomState(3)
    q, k, v, do = _bwd_inputs(rng, cuda, 2, 4, 96, 96, 64, "float32", True)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out, _ = fa.flash_attention_lse(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    ref_out, _ = fa.flash_attention_fwd_plain(*leaves, True, 1 / 8.0)
    want = torch.autograd.grad(ref_out, leaves, do)
    for g, w in zip(got, want):
        tol = 1e-4 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= tol


def _train_tiny_lm(place, steps, ids, labels):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    with fresh_port_programs():
        model = transformer_encoder_model(**dict(TINY_LM, is_test=False))
        _, params_grads = pt.optimizer.Adam(1e-3).minimize(model["loss"])
        exe = pt.Executor(place)
        np.random.seed(0)
        exe.run(pt.default_startup_program())
        fetch = [model["loss"]] + [g for _, g in params_grads]
        first = exe.run(feed={"src_ids": ids, "tgt_label": labels},
                        fetch_list=fetch)
        for _ in range(steps - 1):
            exe.run(feed={"src_ids": ids, "tgt_label": labels})
        params = convert.params_to_numpy(
            pt.global_scope(), [p.name for p, _ in params_grads])
    return first, params


@pytest.mark.cuda
def test_gpu_training_step_matches_cpu(cuda):
    import paddle_tpu_torch as pt

    rng = np.random.RandomState(4)
    shape = (2, TINY_LM["max_len"], 1)
    ids = rng.randint(0, TINY_LM["vocab_size"], shape).astype(np.int64)
    labels = rng.randint(0, TINY_LM["vocab_size"], shape).astype(np.int64)
    fwd, dq, dkv = (fa.flash_attention_fwd.launches,
                    fa.flash_attention_bwd.launches["dq"],
                    fa.flash_attention_bwd.launches["dkv"])
    gpu, gpu_params = _train_tiny_lm(pt.CUDAPlace(0), 2, ids, labels)
    n = TINY_LM["n_layer"]
    assert fa.flash_attention_fwd.launches == fwd + 2 * 2 * n
    assert fa.flash_attention_bwd.launches == {"dq": dq + 2 * n,
                                               "dkv": dkv + 2 * n}
    cpu, cpu_params = _train_tiny_lm(pt.CPUPlace(), 2, ids, labels)
    for g, c in zip(gpu, cpu):
        np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-4)
    # Adam's first steps move each weight by about lr: 2 steps of 1e-3
    for name in cpu_params:
        np.testing.assert_allclose(gpu_params[name], cpu_params[name],
                                   rtol=0, atol=2 * 2e-3 + 1e-4,
                                   err_msg=name)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """The checks run before any build or launch, so they hold on the
    CPU too.  Any head dim is taken (padded to a multiple of 16 where it
    is not one, the wide tile above 128, in 256-column slices above 256),
    and so is a head dim with a non-unit stride (copied, counted); a head
    dim of 0 is not, and float16 is not a kernel dtype."""
    fa._check(*[torch.zeros((1, 1, 8, 24))] * 3)
    fa._check(*[torch.zeros((1, 1, 8, 136))] * 3)
    fa._check(*[torch.zeros((1, 1, 8, 256))] * 3)
    fa._check(*[torch.zeros((1, 1, 8, 264))] * 3)
    fa._check(*[torch.zeros((1, 1, 8, 1000))] * 3)
    q = torch.zeros((1, 1, 8, 0))
    with pytest.raises(ValueError, match="head dim 0"):
        fa._check(q, q, q)
    h = torch.zeros((1, 1, 8, 32), dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        fa._check(h, h, h)
    s = torch.zeros((1, 1, 32, 8)).transpose(2, 3)
    fa._check(s, s, s)
    assert not fa._aligned(s) and fa._aligned(s.contiguous())


# (M, K, N): ragged edges with K or N not a multiple of 8 (the mma.sync
# path, masked loads), and the wgmma path (TMA) with M, K and N off its
# 128 x 256 x 64 tile: K 40 and 72 (one partial K step), N 40 (one w box
# of four), N 136 and 264 (a second, partial tile of columns), M 1000
FC_SHAPES = [(100, 130, 77), (1, 3, 5), (257, 64, 129), (130, 40, 136),
             (256, 512, 512), (300, 2048, 40), (1000, 72, 264)]
FC_ACTS = [("", False), ("relu", False), ("gelu", False), ("gelu", True)]


def _fc_operands(rng, device, m, k, n, dtype, bias_dtype, res_dtype):
    def t(shape, scale, dt):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device,
                                                        getattr(torch, dt))

    return (t((m, k), 1.0, dtype), t((k, n), k ** -0.5, dtype),
            t((n,), 1.0, bias_dtype), t((m, n), 1.0, res_dtype))


def _fc_close(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    if dtype == "float32":
        return (got - want).abs().max().item() <= 1e-4
    return bool(((got - want).abs() <= 1e-2 + 1e-2 * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", FC_SHAPES)
def test_fc_epilogue_kernel_matches_plain(cuda, m, k, n, dtype):
    """Every stage subset, with bias and residual in x's dtype and in the
    other one, on the path the shape takes (counted there)."""
    rng = np.random.RandomState(m + k + n)
    path = ep.fc_kernel_path(k, n, getattr(torch, dtype), True)
    other = "bfloat16" if dtype == "float32" else "float32"
    for bias_dtype, res_dtype in ((dtype, dtype), (other, dtype),
                                  (dtype, other)):
        x, w, b, r = _fc_operands(rng, cuda, m, k, n, dtype, bias_dtype,
                                  res_dtype)
        for has_b in (False, True):
            for has_r in (False, True):
                for act, approx in FC_ACTS:
                    bias, res = b if has_b else None, r if has_r else None
                    launches = ep.fc_epilogue.launches
                    on_path = ep.fc_epilogue.launches_by_path[path]
                    got = ep.fc_epilogue_kernel(x, w, bias, res, act, approx)
                    torch.cuda.synchronize()
                    assert ep.fc_epilogue.launches == launches + 1
                    assert ep.fc_epilogue.launches_by_path[path] == \
                        on_path + 1
                    want = ep.fc_epilogue_plain(x, w, bias, res, act, approx)
                    assert _fc_close(got, want, dtype), \
                        (bias_dtype, res_dtype, has_b, has_r, act, approx)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,spec", [(512, 512, "residual"),
                                      (512, 2048, "bias+relu"),
                                      (2048, 512, "bias+residual")])
def test_fc_epilogue_amp_shapes_take_the_wgmma_path(cuda, k, n, spec):
    """The AMP step's three calls a layer (M = 32 * 512) run on the wgmma
    path and agree with the plain version within FC_TOL (1e-2 of
    max(1, |ref|))."""
    m = 32 * 512
    rng = np.random.RandomState(k + n)
    x, w, b, r = _fc_operands(rng, cuda, m, k, n, "bfloat16", "bfloat16",
                              "bfloat16")
    b = b if "bias" in spec else None
    r = r if "residual" in spec else None
    act = "relu" if "relu" in spec else ""
    before = dict(ep.fc_epilogue.launches_by_path)
    got = ep.fc_epilogue_kernel(x, w, b, r, act)
    torch.cuda.synchronize()
    assert ep.fc_epilogue.launches_by_path == dict(
        before, wgmma=before["wgmma"] + 1)
    want = ep.fc_epilogue_plain(x, w, b, r, act, False).float()
    err = (got.float() - want).abs().max().item()
    assert err <= 1e-2 * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
def test_fc_epilogue_misaligned_operands_take_the_mma_sync_path(cuda):
    """Contiguous x, w and residual whose data starts 2 bytes past a
    16-byte boundary: TMA cannot address them, so the call runs on the
    mma.sync path, and agrees with the plain version."""
    m, k, n = 200, 64, 136
    rng = np.random.RandomState(8)
    x, w, b, r = _fc_operands(rng, cuda, m, k, n, "bfloat16", "bfloat16",
                              "bfloat16")

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    xs, ws, rs = shifted(x), shifted(w), shifted(r)
    assert xs.data_ptr() % 16 and ws.data_ptr() % 16
    before = dict(ep.fc_epilogue.launches_by_path)
    got = ep.fc_epilogue_kernel(xs, ws, b, rs, "relu")
    torch.cuda.synchronize()
    assert ep.fc_epilogue.launches_by_path == dict(
        before, mma_sync=before["mma_sync"] + 1)
    assert _fc_close(got, ep.fc_epilogue_plain(x, w, b, r, "relu", False),
                     "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1000, 512, 2048), (257, 64, 129)])
def test_fc_epilogue_is_deterministic(cuda, m, k, n):
    """Each output element is summed by one CTA in a fixed order: two
    launches give the same bits (wgmma and mma.sync paths)."""
    rng = np.random.RandomState(9)
    x, w, b, r = _fc_operands(rng, cuda, m, k, n, "bfloat16", "float32",
                              "bfloat16")
    first = ep.fc_epilogue_kernel(x, w, b, r, "gelu")
    second = ep.fc_epilogue_kernel(x, w, b, r, "gelu")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,dtype,path", [(16, 16, "bfloat16", "wgmma"),
                                            (12, 16, "bfloat16", "mma_sync"),
                                            (8, 8, "float32", "f32")])
def test_fc_epilogue_takes_more_than_65535_row_tiles(cuda, k, n, dtype,
                                                      path):
    """M = 8,400,000 rows, 65,625 row tiles of 128: more than grid.y
    could hold; the wgmma path walks its tiles persistently, the mma.sync
    and f32 paths put row tiles on grid.x."""
    m = 8_400_000
    assert -(-m // 128) > 65535
    g = torch.Generator(device=cuda).manual_seed(4)
    dt = getattr(torch, dtype)
    x = torch.randn((m, k), generator=g, device=cuda).to(dt)
    w = (torch.randn((k, n), generator=g, device=cuda) * k ** -0.5).to(dt)
    b = torch.randn((n,), generator=g, device=cuda)
    before = ep.fc_epilogue.launches_by_path[path]
    got = ep.fc_epilogue_kernel(x, w, b, None, "relu")
    torch.cuda.synchronize()
    assert ep.fc_epilogue.launches_by_path[path] == before + 1
    assert _fc_close(got, ep.fc_epilogue_plain(x, w, b, None, "relu", False),
                     dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fc_epilogue_grads_match_autograd_of_the_chain(cuda, dtype):
    """The Function launches the kernel forward; its backward is autograd
    of the chain, so the grads equal the chain's exactly."""
    rng = np.random.RandomState(7)
    x, w, b, r = _fc_operands(rng, cuda, 96, 64, 80, dtype, dtype, dtype)
    g = torch.from_numpy(rng.standard_normal((96, 80)).astype(np.float32)
                         ).to(cuda, x.dtype)
    for act, approx in FC_ACTS:
        leaves = [t.detach().requires_grad_() for t in (x, w, b, r)]
        launches = ep.fc_epilogue.launches
        out = ep.fc_epilogue(*leaves, act=act, approximate=approx)
        assert ep.fc_epilogue.launches == launches + 1
        got = torch.autograd.grad(out, leaves, g)
        leaves = [t.detach().requires_grad_() for t in (x, w, b, r)]
        want = torch.autograd.grad(
            ep._fc_reference(*leaves, act, approx), leaves, g)
        for a, e in zip(got, want):
            assert a.dtype == e.dtype
            assert torch.equal(a, e), act


# (N, H, W, Cin, Cout, K, stride, pad): 1x1, 3x3, 5x5 and 7x7 filters,
# strides 1 and 2, the 3-channel stem and a 4-channel 5x5/2 (column pairs
# of 4 channels), Cin 3 at stride 1 (padded to 8), Cin 16 and 24 (K off
# the 64-deep step), every bf16 tile shape (Cout <= 64: 256 x 64; <= 128:
# 256 x 128; above: 128 x 256, two Cout tiles at 300), ragged Cout (24,
# 130, 136: masked w loads and element stores), M off the tile, and
# 256-row tiles that write two partial rows (Cout 64 and 128 at M 576),
# and the space-to-depth stem's 4x4/1 valid conv on 12 channels (Cin
# padded to 16: the general route, not the packed stem's)
CONV_SHAPES = [(2, 9, 9, 16, 32, 3, 1, 1), (2, 9, 9, 16, 24, 3, 2, 1),
               (2, 8, 8, 32, 64, 1, 1, 0), (2, 8, 8, 32, 136, 1, 2, 0),
               (2, 20, 20, 3, 64, 7, 2, 3), (1, 10, 6, 8, 300, 3, 1, 0),
               (3, 14, 14, 64, 130, 3, 1, 1), (4, 12, 12, 24, 64, 3, 1, 1),
               (4, 12, 12, 64, 128, 3, 1, 1), (2, 8, 8, 64, 256, 1, 1, 0),
               (2, 9, 9, 3, 24, 3, 1, 1), (2, 11, 13, 4, 40, 5, 2, 2),
               (2, 19, 19, 12, 64, 4, 1, 0)]


def _conv_operands(rng, device, n, h, w, cin, cout, k, s, p, dtype):
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(
                                    device, getattr(torch, dtype))

    return (t((n, h, w, cin), 1.0), t((cout, cin, k, k), (k * k * cin) ** -.5),
            t((cout,), 1.0), t((n, oh, ow, cout), 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,cin,cout,k,s,p", CONV_SHAPES)
def test_conv_kernels_match_plain(cuda, n, h, w, cin, cout, k, s, p, dtype):
    """Every stage subset, with bias and residual in x's dtype and in the
    other one (an f32 residual is read in place, a bf16 one staged by
    16-byte copies)."""
    rng = np.random.RandomState(n + h + cout)
    x, wt, b, r = _conv_operands(rng, cuda, n, h, w, cin, cout, k, s, p,
                                 dtype)
    other = torch.bfloat16 if dtype == "float32" else torch.float32
    pad = ((p, p), (p, p))
    for bt, rt in ((b, r), (b.to(other), r), (b, r.to(other))):
        for spec in cep_specs():
            bias = bt if "bias" in spec else None
            res = rt if "residual" in spec else None
            launches = cep.conv_epilogue_kernel.launches
            got = cep.conv_epilogue_kernel(x, wt, bias, res, (s, s), pad,
                                           spec.act)
            torch.cuda.synchronize()
            assert cep.conv_epilogue_kernel.launches == launches + 1
            want = cep.conv_epilogue_plain(x, wt, bias, res, (s, s), pad,
                                           spec.act)
            assert _fc_close(got, want, dtype), (spec, bt.dtype, rt.dtype)
    for bias in (None, b):
        launches = cep.conv_stats_kernel.launches
        y, s1, s2 = cep.conv_stats_kernel(x, wt, bias, (s, s), pad)
        torch.cuda.synchronize()
        assert cep.conv_stats_kernel.launches == launches + 1
        assert s1.shape == (-(-y[..., 0].numel() // cep.stats_tile_m()),
                            cout)
        y_ref, r1, r2 = cep.conv_stats_plain(x, wt, bias, (s, s), pad)
        assert _fc_close(y, y_ref, dtype)
        m = float(y[..., 0].numel())
        rel = 1e-4 if dtype == "float32" else 1e-3
        for got_s, want_s in zip(cep._finalize_stats(s1, s2, m),
                                 cep._finalize_stats(r1, r2, m)):
            tol = rel * max(1.0, want_s.abs().max().item())
            assert (got_s - want_s).abs().max().item() <= tol


def cep_specs():
    return list(ep.enumerate_specs("conv"))


@pytest.mark.cuda
def test_conv_kernels_take_more_than_65535_row_tiles(cuda):
    """N*OH*OW = 8,405,000 pixels, 65,665 partials of 128 rows: more
    than grid.y could hold; the bf16 kernel walks its row tiles in a
    persistent loop, the f32 kernel puts them on grid.x."""
    n, h, w, cin, cout = 2, 2050, 2050, 8, 16
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((n, h, w, cin), generator=g, device=cuda).bfloat16()
    wt = (torch.randn((cout, cin, 1, 1), generator=g, device=cuda)
          * cin ** -0.5).bfloat16()
    b = torch.randn((cout,), generator=g, device=cuda)
    m = n * h * w
    tiles = -(-m // cep.stats_tile_m())
    assert tiles > 65535
    got = cep.conv_epilogue_kernel(x, wt, b, None, act="relu")
    assert _fc_close(got, cep.conv_epilogue_plain(x, wt, b, None, act="relu"),
                     "bfloat16")
    y, s1, s2 = cep.conv_stats_kernel(x, wt, b)
    y_ref, r1, r2 = cep.conv_stats_plain(x, wt, b)
    assert s1.shape == s2.shape == (tiles, cout)
    assert _fc_close(y, y_ref, "bfloat16")
    for got_s, want_s in zip(cep._finalize_stats(s1, s2, float(m)),
                             cep._finalize_stats(r1, r2, float(m))):
        tol = 1e-3 * max(1.0, want_s.abs().max().item())
        assert (got_s - want_s).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(16, 64), (3, 128), (64, 256)])
def test_conv_kernels_take_misaligned_views(cuda, cin, cout):
    """x and the residual as views whose data starts 2 bytes past a
    16-byte boundary: the wrapper copies x, the kernel reads the residual
    in place; the result is the plain version's."""
    rng = np.random.RandomState(cin + cout)
    x, wt, b, r = _conv_operands(rng, cuda, 2, 10, 10, cin, cout, 3, 1, 1,
                                 "bfloat16")

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    xv, rv = shifted(x), shifted(r)
    pad = ((1, 1), (1, 1))
    got = cep.conv_epilogue_kernel(xv, wt, b, rv, (1, 1), pad, "relu")
    assert _fc_close(got, cep.conv_epilogue_plain(x, wt, b, r, (1, 1), pad,
                                                  "relu"), "bfloat16")
    y, s1, s2 = cep.conv_stats_kernel(xv, wt, b, (1, 1), pad)
    y_ref, r1, r2 = cep.conv_stats_plain(x, wt, b, (1, 1), pad)
    assert _fc_close(y, y_ref, "bfloat16")
    m = float(y[..., 0].numel())
    for got_s, want_s in zip(cep._finalize_stats(s1, s2, m),
                             cep._finalize_stats(r1, r2, m)):
        tol = 1e-3 * max(1.0, want_s.abs().max().item())
        assert (got_s - want_s).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cout", [64, 128, 256])
def test_conv_stats_is_deterministic(cuda, cout, dtype):
    """No atomics: two launches give the same bits in y, s1 and s2, at
    every tile shape."""
    rng = np.random.RandomState(cout)
    x, wt, b, _ = _conv_operands(rng, cuda, 8, 14, 14, 64, cout, 3, 1, 1,
                                 dtype)
    pad = ((1, 1), (1, 1))
    first = cep.conv_stats_kernel(x, wt, b, (1, 1), pad)
    second = cep.conv_stats_kernel(x, wt, b, (1, 1), pad)
    for a, e in zip(first, second):
        assert torch.equal(a, e)
    out = [cep.conv_epilogue_kernel(x, wt, b, None, (1, 1), pad, "relu")
           for _ in range(2)]
    assert torch.equal(out[0], out[1])


@pytest.mark.cuda
def test_conv_stats_refuses_partials_of_the_wrong_height(cuda, monkeypatch):
    """The entry point checks the partials' row count against its grid, so
    a wrapper that sized them for another tile height raises instead of
    writing past them."""
    from paddle_tpu_torch import _build

    cep.stats_tile_m()                       # builds and loads the library
    monkeypatch.setattr(_build.load("conv_epilogue"), "pt_conv_tile_m",
                        lambda: 64)
    rng = np.random.RandomState(1)
    x, wt, _, _ = _conv_operands(rng, cuda, 2, 16, 16, 16, 32, 3, 1, 1,
                                 "bfloat16")
    with pytest.raises(RuntimeError, match="conv_stats kernel launch failed"):
        cep.conv_stats_kernel(x, wt, None, (1, 1), ((1, 1), (1, 1)))


# (N, H, W, C): C a multiple of 8 (16-byte loads) and ragged
BN_SHAPES = [(2, 7, 7, 64), (3, 5, 4, 24), (2, 3, 3, 13), (128, 7, 7, 2048),
             # every ResNet-50 shape class at batch 2 (spatial 112 to 7,
             # C 64 to 2048: one to two hundred fifty-six octets a row)
             (2, 112, 112, 64), (2, 56, 56, 64), (2, 56, 56, 256),
             (2, 28, 28, 128), (2, 28, 28, 512), (2, 14, 14, 256),
             (2, 14, 14, 1024), (2, 7, 7, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c", BN_SHAPES)
def test_bn_apply_kernel_matches_plain(cuda, n, h, w, c, dtype):
    rng = np.random.RandomState(c)

    def t(shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda, getattr(torch, dt))

    y, res = t((n, h, w, c)), t((n, h, w, c))
    mean, scale, shift = t((c,), "float32"), t((c,), "float32"), \
        t((c,), "float32")
    rstd = torch.rsqrt(t((c,), "float32").abs() + 0.5)
    for r in (None, res, res.float() if dtype == "bfloat16" else None):
        for act in ("", "relu"):
            launches = cep.bn_apply_kernel.launches
            got = cep.bn_apply_kernel(y, mean, rstd, scale, shift, r, act)
            torch.cuda.synchronize()
            assert cep.bn_apply_kernel.launches == launches + 1
            want = cep.bn_apply_plain(y, mean, rstd, scale, shift, r, act)
            assert got.dtype == want.dtype == y.dtype
            scale_ = max(1.0, want.float().abs().max().item())
            tol = 1e-6 if dtype == "float32" else 1e-2
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * scale_, (r is None, act, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 2048, 1200])
def test_bn_apply_tiled_and_masked_kernels_agree(cuda, c, dtype):
    """The tiled kernel (aligned rows, C a multiple of 8) and the masked
    one (a view 4 bytes off 16-byte alignment) round at the same points:
    their outputs are bit-equal, with and without a residual and relu.
    C 1200 takes more than one span of 256 octets."""
    rng = np.random.RandomState(c)
    n, h, w = 3, 5, 7
    m = n * h * w * c

    def t(shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda, getattr(torch, dt))

    mean, scale, shift = t((c,), "float32"), t((c,), "float32"), \
        t((c,), "float32")
    rstd = torch.rsqrt(t((c,), "float32").abs() + 0.5)
    buf, rbuf = t((m + 8,)), t((m + 8,), "float32")
    off = 4 // buf.element_size()
    y_off = buf[off:off + m].view(n, h, w, c)
    res_off = rbuf[1:1 + m].view(n, h, w, c)
    y, res = y_off.clone(), res_off.clone()   # fresh, aligned
    for r, r_off in ((None, None), (res, res_off)):
        for act in ("", "relu"):
            tiled = cep.bn_apply_kernel(y, mean, rstd, scale, shift, r, act)
            masked = cep.bn_apply_kernel(y_off, mean, rstd, scale, shift,
                                         r_off, act)
            torch.cuda.synchronize()
            assert torch.equal(tiled, masked), (r is None, act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_functions_grads_on_the_card(cuda, dtype):
    """The Functions' backwards are the same PyTorch code whichever
    forward ran, so the kernel's grads match the plain version's within
    the forward's own difference."""
    rng = np.random.RandomState(5)
    x, w, b, r = _conv_operands(rng, cuda, 2, 9, 9, 16, 24, 3, 2, 1, dtype)
    g = torch.from_numpy(rng.standard_normal(tuple(r.shape)).astype(
        np.float32)).to(cuda, x.dtype)
    scale = torch.ones(24, device=cuda) * 1.5
    shift = torch.zeros(24, device=cuda) + 0.1
    tol = 1e-4 if dtype == "float32" else 5e-2

    def grads(fn, impl, *ts):
        leaves = [t.detach().requires_grad_() for t in ts]
        out = fn(leaves, impl)
        return torch.autograd.grad(out, leaves, g)

    def ep_fn(ls, impl):
        return cep.conv2d_epilogue(*ls, strides=(2, 2), paddings=(1, 1),
                                   act="relu", impl=impl)

    def bn_fn(ls, impl):
        return cep.conv2d_bn_act(ls[0], ls[1], ls[2], ls[3],
                                 residual=ls[4], strides=(2, 2),
                                 paddings=(1, 1), act="relu", impl=impl)[0]

    for fn, ts in ((ep_fn, (x, w, b, r)), (bn_fn, (x, w, scale, shift, r))):
        for a, e in zip(grads(fn, "pallas", *ts), grads(fn, "interpret", *ts)):
            assert a.dtype == e.dtype
            err = (a.float() - e.float()).abs().max().item()
            assert err <= tol * max(1.0, e.float().abs().max().item())


@pytest.mark.cuda
def test_gpu_resnet_step_matches_cpu(cuda):
    """A tiny ResNet (stem, max pool, two bottlenecks) under
    fuse_conv_bn_train, f32: the card with the kernels (flag on) against
    the CPU with their plain versions (flag interpret)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import resnet as rn

    def run(place, mode):
        pt.set_flags({"conv_bn_stats": mode})
        try:
            with fresh_port_programs():
                layers = pt.layers
                image = layers.data("image", shape=[3, 32, 32])
                label = layers.data("label", shape=[1], dtype="int64")
                x = rn._conv_bn(image, 16, 7, stride=2, act="relu")
                x = layers.pool2d(x, pool_size=3, pool_stride=2,
                                  pool_padding=1, pool_type="max")
                x = rn._bottleneck(x, 8, 2)
                x = rn._bottleneck(x, 8, 1)
                pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
                loss = layers.mean(layers.softmax_with_cross_entropy(
                    layers.fc(pool, size=10), label))
                main = pt.default_main_program()
                pt.transpiler.fuse_conv_bn_train(main, protected=[loss.name])
                pt.transpiler.nhwc_transpile(main)
                _, pg = pt.optimizer.Momentum(0.1, 0.9).minimize(loss)
                exe = pt.Executor(place)
                np.random.seed(0)
                exe.run(pt.default_startup_program())
                rng = np.random.RandomState(1)
                feed = {"image": rng.rand(4, 3, 32, 32).astype(np.float32),
                        "label": rng.randint(0, 10, (4, 1))}
                out = exe.run(feed=feed, fetch_list=[loss] + [
                    g for _, g in pg])
                exe.run(feed=feed)
                return out, convert.params_to_numpy(
                    pt.global_scope(), [p.name for p, _ in pg])
        finally:
            pt.set_flags({"conv_bn_stats": "off"})

    launches = cep.conv_stats_kernel.launches, cep.bn_apply_kernel.launches
    gpu, gpu_params = run(pt.CUDAPlace(0), "on")
    # 8 fused convs, each run forward and again in its grad, 2 steps
    assert (cep.conv_stats_kernel.launches - launches[0],
            cep.bn_apply_kernel.launches - launches[1]) == (32, 32)
    cpu, cpu_params = run(pt.CPUPlace(), "interpret")
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-4)
    for g, c in zip(gpu[1:], cpu[1:]):
        assert np.abs(g - c).max() <= 1e-3 * max(1.0, np.abs(c).max())
    for name in cpu_params:
        np.testing.assert_allclose(gpu_params[name], cpu_params[name],
                                   rtol=0, atol=1e-3, err_msg=name)


# ---------------------------------------------------------------------------
# flash_decode: the paged decode kernel
# ---------------------------------------------------------------------------

# (lens, R, d, page size, dtype, strided tables)
DECODE_CASES = [
    ([5, 33, 16, 1], 1, 64, 16, "float32", False),
    ([5, 33, 16, 0], 5, 128, 16, "float32", False),   # a zero-length row
    ([40, 7, 129], 9, 16, 4, "float32", True),        # many tiny pages
    ([200, 3], 1, 128, 128, "float32", True),
    ([30, 64, 65], 20, 64, 32, "float32", False),
    ([5, 33, 16, 1], 1, 64, 16, "bfloat16", False),
    ([17, 90], 5, 128, 48, "bfloat16", True),         # ragged chunks
    ([5, 33, 64], 1, 64, 32, "int8", False),
    ([70, 9], 5, 128, 16, "int8", True),
    # head dims off 16-byte rows or above 128 (d 72 over int8 pages: 72-byte
    # rows, copied element by element), 70 verify rows, one long sequence
    # (32 splits)
    ([5, 33, 300, 1], 5, 72, 16, "float32", False),
    ([70, 9, 300], 3, 72, 16, "int8", True),
    ([17, 90, 260, 0], 5, 160, 32, "bfloat16", True),
    ([129, 7, 300], 3, 256, 32, "float32", False),
    ([129, 7, 300], 2, 256, 16, "int8", False),
    ([100, 75, 600, 70], 70, 64, 16, "float32", False),
    ([32768], 1, 128, 128, "float32", False),
    # above d 1024: chunks of 4 keys, 16 output columns a thread
    ([5, 33, 300, 1], 1, 1536, 16, "float32", False),
    ([70, 9, 300], 5, 1536, 16, "bfloat16", True),
    ([17, 90, 260, 0], 5, 2048, 32, "float32", True),
    ([129, 7, 300], 1, 2048, 16, "bfloat16", False),
    ([70, 9, 300], 5, 1536, 32, "int8", True),
    ([129, 7, 300], 1, 2048, 16, "int8", False),
    # above d 2048: the wide kernel (head dim in slices, output columns in
    # 2048-column slices); d 2056 and 3080 off whole 16-byte int8 rows
    ([5, 33, 300, 1], 1, 2056, 16, "float32", False),
    ([70, 9, 300], 5, 3072, 16, "bfloat16", True),
    ([17, 90, 260, 0], 5, 3072, 32, "float32", True),
    ([129, 7, 300], 1, 4096, 16, "bfloat16", False),
    ([70, 9, 300], 5, 3080, 16, "int8", True),
    ([129, 7, 300], 1, 4096, 16, "int8", False),
    ([40, 7, 33], 5, 4096, 2, "float32", True),        # 2-key pages
]
# relative to max(1, |ref|): f32 sums in another order; bf16 output is
# one rounding of those sums, so one bf16 step apart at most
DECODE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8, "int8": 1e-5}


def _decode_inputs(seed, lens, r, d, ps, dtype, strided, device, h=2):
    """Random pools, block tables over distinct pages (column-major
    round robin when ``strided``), padded entries at page 0, and q."""
    rng = np.random.RandomState(seed)
    b = len(lens)
    mp = max(1, max(-(-n // ps) for n in lens))
    n_pages = b * mp + 1
    if dtype == "int8":
        k, v = (torch.from_numpy(rng.randint(-127, 128, (n_pages, h, ps, d))
                                 .astype(np.int8)) for _ in range(2))
        scales = tuple(torch.from_numpy(rng.uniform(0.5, 2.0, (h, d))
                                        .astype(np.float32)).to(device)
                       for _ in range(2))
        qdt = torch.float32
    else:
        qdt = getattr(torch, dtype)
        k, v = (torch.from_numpy(rng.standard_normal((n_pages, h, ps, d))
                                 .astype(np.float32)).to(qdt)
                for _ in range(2))
        scales = None
    pages = 1 + rng.permutation(b * mp)
    tables = pages.reshape(mp, b).T if strided else pages.reshape(b, mp)
    tables = np.ascontiguousarray(tables).astype(np.int32)
    for i, n in enumerate(lens):
        tables[i, -(-n // ps):] = 0
    shape = (b, h, d) if r == 1 else (b, r, h, d)
    q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return (q.to(device, qdt), k.to(device), v.to(device),
            torch.from_numpy(tables).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device), scales)


@pytest.mark.cuda
@pytest.mark.parametrize("lens,r,d,ps,dtype,strided", DECODE_CASES)
def test_flash_decode_kernel_matches_plain(cuda, lens, r, d, ps, dtype,
                                           strided):
    from paddle_tpu_torch.ops import flash_decode as fd

    q, k, v, tab, ln, scales = _decode_inputs(3, lens, r, d, ps, dtype,
                                              strided, cuda)
    before = fd.flash_decode.launches
    out = fd.flash_decode(q, k, v, tab, ln, kv_scales=scales)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    ref = fd.flash_decode_plain(q, k, v, tab, ln, kv_scales=scales)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= DECODE_TOL[dtype] * max(1.0, ref.float().abs().max().item())
    zero = [i for i, n in enumerate(lens) if n == 0]
    if zero:
        assert torch.equal(out[zero], torch.zeros_like(out[zero]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_flash_decode_verify_rows_bit_equal_qlen1(cuda, dtype):
    """Verify row r is array_equal to a q-len-1 launch at length
    len - R + 1 + r: the numerical half of lossless speculation."""
    from paddle_tpu_torch.ops import flash_decode as fd

    r = 6
    q, k, v, tab, ln, scales = _decode_inputs(
        4, [9, 33, 70, 128], r, 128, 32, dtype, True, cuda)
    out = fd.flash_decode(q, k, v, tab, ln, kv_scales=scales)
    for i in range(r):
        one = fd.flash_decode(q[:, i].contiguous(), k, v, tab,
                              ln - (r - 1 - i), kv_scales=scales)
        assert torch.equal(one, out[:, i]), i


# (lens, R, d, page size): lengths on both sides of a split boundary (16
# pages: 256 keys at page 16), so verify rows of one sweep fall in one or
# two splits; 70 rows (five row blocks) over several splits; d 16 (64-key
# chunks of four pages)
SPLIT_VERIFY_CASES = [
    ([254, 256, 258, 259, 513, 1030], 5, 64, 16),
    ([256, 257, 260, 1025], 5, 128, 16),
    ([100, 75, 600, 70], 70, 64, 16),
    ([70, 33, 300, 129], 5, 16, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("lens,r,d,ps", SPLIT_VERIFY_CASES)
def test_flash_decode_verify_rows_bit_equal_across_splits(cuda, lens, r, d,
                                                          ps, dtype):
    """Verify rows stay array_equal to q-len-1 launches whichever row
    block and however many splits either launch has: split points follow
    the page index, a split past a row's limit is an exact no-op of the
    merge."""
    from paddle_tpu_torch.ops import flash_decode as fd

    q, k, v, tab, ln, scales = _decode_inputs(6, lens, r, d, ps, dtype,
                                              False, cuda)
    out = fd.flash_decode(q, k, v, tab, ln, kv_scales=scales)
    for i in range(r):
        one = fd.flash_decode(q[:, i].contiguous(), k, v, tab,
                              (ln - (r - 1 - i)).clamp_min(0),
                              kv_scales=scales)
        assert torch.equal(one, out[:, i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [1536, 2048, 2056, 3072, 4096])
def test_flash_decode_wide_verify_rows_bit_equal_qlen1(cuda, d, dtype):
    """Above d 1024 (chunks of 4 keys, which follow the pools' d alone;
    above 2048 the wide kernel) verify row r of a 5-row sweep is still
    array_equal to a q-len-1 launch at length len - 4 + r, across split
    boundaries (300 tokens of 16-token pages: two splits)."""
    from paddle_tpu_torch.ops import flash_decode as fd

    r = 5
    q, k, v, tab, ln, scales = _decode_inputs(
        8, [9, 33, 300, 258], r, d, 16, dtype, True, cuda)
    out = fd.flash_decode(q, k, v, tab, ln, kv_scales=scales)
    for i in range(r):
        one = fd.flash_decode(q[:, i].contiguous(), k, v, tab,
                              ln - (r - 1 - i), kv_scales=scales)
        assert torch.equal(one, out[:, i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_flash_decode_is_deterministic(cuda, dtype):
    """Two launches over many splits give the same bits: the splits are
    merged in order, with no atomics."""
    from paddle_tpu_torch.ops import flash_decode as fd

    q, k, v, tab, ln, scales = _decode_inputs(7, [4000, 1030, 77], 5, 128,
                                              16, dtype, True, cuda)
    first = fd.flash_decode(q, k, v, tab, ln, kv_scales=scales)
    assert torch.equal(first,
                       fd.flash_decode(q, k, v, tab, ln, kv_scales=scales))


@pytest.mark.cuda
def test_flash_decode_refuses_what_the_kernel_does_not_take(cuda):
    """What the kernel took no longer (a head dim off multiples of 8, more
    than 64 query rows) runs and is counted; q of another dtype than the
    pools' and a head dim of 0 are refused (every positive head dim runs:
    above 2048 on the wide kernel)."""
    from paddle_tpu_torch.ops import flash_decode as fd

    q, k, v, tab, ln, _ = _decode_inputs(5, [5], 1, 64, 16, "float32",
                                         False, cuda)
    for args in ((q[..., :60], k[..., :60].contiguous(),
                  v[..., :60].contiguous(), tab, ln),
                 (q[:, None].expand(1, 65, 2, 64), k, v, tab, ln)):
        before = fd.flash_decode.launches
        out = fd.flash_decode(*args)
        torch.cuda.synchronize()
        assert fd.flash_decode.launches == before + 1
        ref = fd.flash_decode_plain(*args)
        assert (out - ref).abs().max().item() <= 1e-5 * max(
            1.0, ref.abs().max().item())
    with pytest.raises(TypeError):
        fd.flash_decode(q.bfloat16(), k, v, tab, ln)
    empty = torch.zeros((1, 2, 16, 0), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fd.flash_decode(torch.zeros((1, 2, 0), device=cuda), empty, empty,
                        tab, ln, scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("knob", [{}, {"spec_k": 2}, {"kv_int8": True}])
def test_gpu_decode_server_matches_cpu(cuda, knob):
    """The tiny decode server on the card and on the CPU emit the same
    tokens; every decode step launched the kernel ((k+1) launches a
    speculative round)."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.ops import flash_decode as fd

    rng = np.random.RandomState(0)
    prompts = [rng.randint(2, 128, size=int(rng.randint(1, 40)))
               for _ in range(8)]
    outs = {}
    for device in ("cuda", "cpu"):
        before = fd.flash_decode.launches
        srv = serving.DecodeServer(config=serving.DecodeConfig(
            max_batch=4, max_new_tokens=10, page_size=16, num_pages=60,
            device=device, **knob)).start()
        try:
            futs = [srv.submit(p) for p in prompts]
            outs[device] = [list(f.result(timeout=120.0)[0]) for f in futs]
        finally:
            srv.stop()
        ok, detail = srv.page_accounting()
        assert ok, detail
        if device == "cuda":
            per = knob.get("spec_k", 0) + 1
            assert fd.flash_decode.launches - before == \
                per * srv.stats()["decode"]["iterations"]
    assert outs["cuda"] == outs["cpu"]


# ---------------------------------------------------------------------------
# conv_int8: the s8 convolution and its epilogue
# ---------------------------------------------------------------------------

# (N, H, W, Cin, Cout, K, stride, pad, dilation, groups): odd Cin and Cout,
# the 3-channel stem, 1x1, stride 2, dilation 2, groups 2 and 4, M off the
# 128-pixel tile, Cout off the 64-channel tile, a mul_int8 shape as a 1x1
# convolution over [M, 1, 1, K]
I8_SHAPES = [
    (2, 9, 9, 24, 20, 3, 1, 1, 1, 1),
    (2, 20, 20, 3, 64, 7, 2, 3, 1, 1),
    (3, 7, 7, 40, 130, 1, 1, 0, 1, 1),
    (2, 13, 11, 20, 12, 3, 2, 2, 2, 1),
    (2, 7, 7, 24, 10, 3, 1, 1, 1, 2),
    (2, 8, 8, 64, 32, 3, 2, 1, 1, 4),
    (2, 14, 14, 256, 64, 1, 1, 0, 1, 1),
    (300, 1, 1, 2048, 1000, 1, 1, 0, 1, 1),
    # the wgmma route's tiles by Cout (64, 128, 256 and two 256-column
    # tiles), M off the 256- and 128-pixel tiles, a strided 3x3 and a
    # strided 1x1 (gathered), a 1x1 of 64 channels by TMA, a 1-channel stem
    (2, 9, 9, 32, 64, 3, 2, 1, 1, 1),
    (3, 10, 10, 48, 128, 3, 1, 1, 1, 1),
    (2, 7, 7, 64, 256, 1, 1, 0, 1, 1),
    (2, 14, 14, 128, 512, 1, 2, 0, 1, 1),
    (2, 17, 15, 1, 40, 5, 2, 2, 1, 1),
    (2, 9, 11, 3, 16, 3, 1, 1, 1, 1),      # a 3-channel conv at stride 1
]
# (out dtype, bias, residual, relu, OutScale)
I8_EPILOGUES = [
    ("int32", None, None, False, False),
    ("float32", None, None, False, False),
    ("bfloat16", "float32", None, True, False),
    ("bfloat16", "bfloat16", "bfloat16", True, False),
    ("float32", "bfloat16", "float32", False, False),
    ("bfloat16", "float32", "bfloat16", True, True),
    ("float32", None, None, False, True),
]


def _i8_case(device, n, h, w, cin, cout, k, s, p, d, g, seed=0):
    rng = np.random.RandomState(seed)
    x8 = torch.from_numpy(rng.randint(-127, 128, (n, h, w, cin))
                          .astype(np.int8)).to(device)
    wt = torch.from_numpy(rng.randint(-127, 128, (cout, cin // g, k, k))
                          .astype(np.int8)).to(device)
    oh = (h + 2 * p - (k - 1) * d - 1) // s + 1
    ow = (w + 2 * p - (k - 1) * d - 1) // s + 1
    return rng, x8, wt, (n, oh, ow, cout)


def _i8_operands(rng, device, shape, epilogue):
    out, bias, res, relu, outscale = epilogue
    cout = shape[3]
    alpha = torch.tensor(rng.uniform(1e-5, 1e-4), dtype=torch.float32,
                         device=device)
    col = torch.from_numpy(rng.uniform(0.5, 2.0, cout).astype(np.float32)
                           ).to(device)

    def make(dtype, shp):
        if dtype is None:
            return None
        return torch.from_numpy(rng.standard_normal(shp).astype(np.float32)
                                ).to(device, getattr(torch, dtype))

    return dict(alpha=alpha, colscale=col, bias=make(bias, (cout,)),
                residual=make(res, shape), relu=relu,
                out_scale=torch.tensor([rng.uniform(1.0, 3.0)],
                                       dtype=torch.float32, device=device)
                if outscale else None,
                out_dtype=getattr(torch, out))


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", I8_EPILOGUES,
                         ids=["-".join(str(v) for v in e)
                              for e in I8_EPILOGUES])
@pytest.mark.parametrize("n,h,w,cin,cout,k,s,p,d,g", I8_SHAPES)
def test_conv_int8_kernel_equals_plain(cuda, n, h, w, cin, cout, k, s, p,
                                       d, g, epilogue):
    """The kernel's output is torch.equal to the plain version's on the
    card: the int32 sum is exact and every float step is fixed."""
    from paddle_tpu_torch.ops import quant as Q

    rng, x8, wt, shape = _i8_case(cuda, n, h, w, cin, cout, k, s, p, d, g)
    ops = _i8_operands(rng, cuda, shape, epilogue)
    conv = dict(strides=(s, s), paddings=(p, p), dilations=(d, d),
                groups=g)
    launches = Q.conv_int8.launches
    got = Q.conv_int8(x8, wt, **ops, **conv)
    torch.cuda.synchronize()
    assert Q.conv_int8.launches == launches + 1
    want = Q.conv_int8_plain(x8, wt, **ops, **conv)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,k,s,p,d,g", I8_SHAPES)
def test_conv_int8_routes_agree(cuda, n, h, w, cin, cout, k, s, p, d, g):
    """Each shape's own route (wgmma, the packed stem's wgmma, or mma.sync
    for groups) is counted on it and gives the mma.sync kernel's bits,
    which every convolution also takes on request."""
    from paddle_tpu_torch.ops import quant as Q

    rng, x8, wt, shape = _i8_case(cuda, n, h, w, cin, cout, k, s, p, d, g)
    ops = _i8_operands(rng, cuda, shape, I8_EPILOGUES[5])
    conv = dict(strides=(s, s), paddings=(p, p), dilations=(d, d),
                groups=g)
    route = Q.kernel_route(cin // g, g, (s, s), (d, d))
    assert route == ("mma_sync" if g > 1 else
                     "wgmma_stem" if cin <= 4 and s % 2 == 0 else "wgmma")
    before = dict(Q.conv_int8.launches_by_route)
    got = Q.conv_int8(x8, wt, **ops, **conv)
    assert Q.conv_int8.launches_by_route[route] == before[route] + 1
    ref = Q.conv_int8(x8, wt, **ops, **conv, route="mma_sync")
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if g > 1:
        with pytest.raises(ValueError, match="route"):
            Q.conv_int8(x8, wt, **ops, **conv, route="wgmma")


@pytest.mark.cuda
def test_conv_int8_takes_misaligned_views_and_is_deterministic(cuda):
    """A view starting off 16 bytes is copied once (counted) and gives the
    contiguous tensor's bits; two launches give the same bits."""
    from paddle_tpu_torch.ops import quant as Q

    rng, x8, wt, shape = _i8_case(cuda, 2, 9, 9, 32, 48, 3, 1, 1, 1, 1)
    ops = _i8_operands(rng, cuda, shape, I8_EPILOGUES[5])
    base = torch.zeros(x8.numel() + 3, dtype=torch.int8, device=cuda)
    view = base[3:].view(x8.shape)
    view.copy_(x8)
    assert view.data_ptr() % 16 != 0
    copies = Q.conv_int8.copies
    got = Q.conv_int8(view, wt, **ops, paddings=(1, 1))
    assert Q.conv_int8.copies == copies + 1
    again = Q.conv_int8(x8, wt, **ops, paddings=(1, 1))
    assert Q.conv_int8.copies == copies + 1
    assert torch.equal(got, again)
    assert torch.equal(again, Q.conv_int8(x8, wt, **ops, paddings=(1, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["conv2d_int8", "mul_int8"])
def test_int8_ops_on_the_card_equal_the_cpu(cuda, op):
    """The ops on a CUDA tensor launch the kernel once and give the CPU
    op's bits: the activation's quantisation and the scales are the same
    f32 arithmetic on both (divisions by the op's Python floats are true
    divisions on the card too, as in jnp, not products with a
    reciprocal); the scales are not powers of two."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.ops import quant as Q

    rng = np.random.RandomState(5)
    if op == "conv2d_int8":
        ins = {"Input": rng.standard_normal((2, 10, 10, 24)) * 2,
               "Filter": rng.randint(-127, 128, (40, 24, 3, 3)),
               "FilterScale": rng.uniform(0.005, 0.02, (40, 1, 1, 1)),
               "InScale": [3.7], "Bias": rng.standard_normal(40),
               "Residual": rng.standard_normal((2, 10, 10, 40)),
               "OutScale": [2.9]}
        attrs = {"data_format": "NHWC", "paddings": [1, 1],
                 "out_dtype": "bfloat16", "fuse_relu": True}
    else:
        ins = {"X": rng.standard_normal((9, 2048)) * 2,
               "Y": rng.randint(-127, 128, (2048, 1000)),
               "Scale": rng.uniform(0.005, 0.02, (1, 1000)),
               "InScale": [3.7]}
        attrs = {"out_dtype": "bfloat16"}
    dtypes = {"Filter": torch.int8, "Y": torch.int8}
    tensors = {k: torch.tensor(np.asarray(v), dtype=dtypes.get(
        k, torch.float32)) for k, v in ins.items()}
    opdef = registry.get_op_def(op)
    attrs = opdef.canonical_attrs(attrs)
    cpu = opdef.compute(tensors, attrs, torch.device("cpu"))
    launches = Q.conv_int8.launches
    gpu = opdef.compute({k: v.to(cuda) for k, v in tensors.items()}, attrs,
                        cuda)
    torch.cuda.synchronize()
    assert Q.conv_int8.launches == launches + 1
    for slot, v in cpu.items():
        assert torch.equal(gpu[slot].cpu(), v), slot


# ---------------------------------------------------------------------------
# quantize_act: the int8 ops' activation quantisation
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1,), (15,), (16,), (1001,),
                                   (2, 3, 57, 33), (128, 64, 7, 7)])
def test_quantize_act_equals_plain(cuda, shape, dtype):
    """Odd sizes (the scalar tail beside the 16-element groups), values
    beyond +-bnd, exact .5 ties and a scale read on the card: torch.equal
    to the plain version, one launch."""
    from paddle_tpu_torch.ops import quant as Q

    rng = np.random.RandomState(len(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 30.0
    flat = x.reshape(-1)
    flat[::3] = np.round(flat[::3]) + 0.5     # ties at sx = bnd
    xt = torch.from_numpy(x).to(cuda, getattr(torch, dtype))
    for sx, bnd in ((torch.tensor(64.0), 64.0), (torch.tensor(3.7), 127.0)):
        sx = sx.to(cuda)
        launches = Q.quantize_act.launches
        got = Q.quantize_act(xt, sx, bnd)
        torch.cuda.synchronize()
        assert Q.quantize_act.launches == launches + 1
        want = Q.quantize_act_plain(xt, sx, bnd)
        assert got.dtype == torch.int8 and got.shape == xt.shape
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_takes_views(cuda, dtype):
    """A view off 16 bytes runs the element path; a channels-last or
    permuted view keeps its layout (no copy); a strided view is copied
    (counted): each torch.equal to the plain version."""
    from paddle_tpu_torch.ops import quant as Q

    base = torch.randn(4 * 10 * 12 * 24 + 3, device=cuda).to(
        getattr(torch, dtype)) * 20
    sx = torch.tensor(2.9, device=cuda)
    views = {"off16": base[3:].view(4, 10, 12, 24),
             "nhwc_of_nchw": base[:-3].view(4, 10, 12, 24).permute(0, 3, 1, 2),
             "strided": base[:-3].view(4, 10, 12, 24)[:, :, ::2]}
    for name, v in views.items():
        copies = Q.quantize_act.copies
        got = Q.quantize_act(v, sx, 127.0)
        torch.cuda.synchronize()
        assert Q.quantize_act.copies == copies + int(name == "strided")
        if name == "nhwc_of_nchw":
            assert got.stride() == v.stride()
        assert torch.equal(got, Q.quantize_act_plain(v, sx, 127.0)), name


# ---------------------------------------------------------------------------
# CompiledProgram on the card: the block captured into CUDA graphs
# ---------------------------------------------------------------------------

def _register_planted_ops():
    """Two ops that synchronise the card: one always (``.item()``), one
    only while a stream captures (so the eager warm-up passes)."""
    from paddle_tpu_torch.core.registry import _REGISTRY, register_op

    if "_test_sync_always" in _REGISTRY:
        return

    @register_op("_test_sync_always", inputs=("X",), outputs=("Out",),
                 differentiable=False)
    def _sync_always(ins, attrs, device):
        x = ins["X"]
        return {"Out": x * float(x.abs().max().item() > -1.0)}

    @register_op("_test_sync_in_capture", inputs=("X",), outputs=("Out",),
                 differentiable=False)
    def _sync_in_capture(ins, attrs, device):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return {"Out": ins["X"] * 2.0}


def _mlp(planted=None, train=True):
    """An fc-relu-fc MLP with Adam in the default programs (``planted``:
    an op type applied to the hidden layer).  Returns (loss name, the
    hidden var's name)."""
    import paddle_tpu_torch as pt

    x = pt.layers.data("x", shape=[16], dtype="float32")
    h = pt.layers.fc(x, size=32, act="relu")
    if planted is not None:
        block = pt.default_main_program().global_block()
        out = block.create_var(name="planted_out", shape=h.shape,
                               dtype="float32")
        block.append_op(planted, inputs={"X": [h]}, outputs={"Out": [out]})
        h = out
    loss = pt.layers.mean(pt.layers.fc(h, size=4))
    if train:
        pt.optimizer.Adam(1e-2).minimize(loss)
    return loss.name, h.name


def _mlp_x(batch, seed=0):
    return np.random.RandomState(seed).rand(batch, 16).astype(np.float32)


def _persistable_state(scope, main):
    return {v.name: scope.find_var(v.name).get().clone()
            for v in main.persistables() if not v.is_data}


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mlp_adam", "tiny_lm_forward"])
def test_compiled_program_equals_interpreted_on_the_card(cuda, model):
    """Three compiled runs (the eager warm-up, then two replays) against
    three interpreted ones from the same start: every fetch and
    persistable equal, the replays' launches equal to the interpreted
    run's, and the persistables at the same addresses throughout."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model
    from paddle_tpu_torch.ops import kernel_launches

    with fresh_port_programs():
        if model == "mlp_adam":
            fetch, _ = _mlp()
            feed = {"x": _mlp_x(8)}
            # a parameter too: its buffer changes in every replay
            param = pt.default_main_program().all_parameters()[0].name
        else:
            fetch = transformer_encoder_model(**TINY_LM)["logits"].name
            param = None
            feed = {n: np.random.RandomState(2).randint(
                0, TINY_LM["vocab_size"],
                (2, TINY_LM["max_len"], 1)).astype(np.int64)
                for n in ("src_ids", "tgt_label")}
        main = pt.default_main_program()
        startup = pt.default_startup_program()
        runs = []
        for compiled in (False, True):
            exe = pt.Executor(pt.CUDAPlace(0))
            scope = pt.Scope()
            np.random.seed(0)
            exe.run(startup, scope=scope)
            prog = pt.CompiledProgram(main) if compiled else main
            outs, launches = [], []
            for _ in range(3):
                before = kernel_launches()
                outs.append(exe.run(
                    prog, feed=feed, scope=scope,
                    fetch_list=[fetch] + ([param] if param else [])))
                after = kernel_launches()
                launches.append({k: after[k] - before[k] for k in after})
                if compiled and len(outs) == 1:
                    ptrs = {v.name: scope.find_var(v.name).get().data_ptr()
                            for v in main.persistables() if not v.is_data}
            runs.append((outs, _persistable_state(scope, main), launches,
                         prog))
        (want, want_state, want_launches, _), (got, got_state, got_l,
                                               prog) = runs
        for g, w in zip(got, want):
            for gv, wv in zip(g, w):
                np.testing.assert_array_equal(gv, wv)
        assert all(torch.equal(got_state[n], want_state[n])
                   for n in want_state)
        assert {v.name: scope.find_var(v.name).get().data_ptr()
                for v in main.persistables() if not v.is_data} == ptrs
        # the replays launched nothing from Python; the capture's deltas
        # times the replays equal the interpreted runs' launches
        assert all(not any(d.values()) for d in got_l[1:])
        per_run = {k: v for k, v in want_launches[0].items() if v}
        assert prog.replayed_launches() == {k: 2 * v
                                            for k, v in per_run.items()}
        assert prog.graph_stats() == {"entries": 1, "graphs": 1,
                                      "replays": 2}
        if model == "tiny_lm_forward":
            assert per_run["flash_attention_fwd"] == TINY_LM["n_layer"]


@pytest.mark.cuda
def test_replayed_step_equals_an_eager_step(cuda):
    """From one state, a replayed training step and an interpreted one
    give the same loss and the same persistables after."""
    import paddle_tpu_torch as pt

    with fresh_port_programs():
        loss, _ = _mlp()
        main = pt.default_main_program()
        exe = pt.Executor(pt.CUDAPlace(0))
        np.random.seed(0)
        exe.run(pt.default_startup_program())
        scope = pt.global_scope()
        prog = pt.CompiledProgram(main)
        exe.run(prog, feed={"x": _mlp_x(8)}, fetch_list=[loss])
        start = _persistable_state(scope, main)
        feed = {"x": _mlp_x(8, 1)}
        replayed = exe.run(prog, feed=feed, fetch_list=[loss])[0]
        assert prog.graph_stats()["replays"] == 1
        after_replay = _persistable_state(scope, main)
        for n, t in start.items():
            scope.var(n).set(t.clone())
        eager = exe.run(main, feed=feed, fetch_list=[loss])[0]
        np.testing.assert_array_equal(replayed, eager)
        eager_state = _persistable_state(scope, main)
        assert all(torch.equal(after_replay[n], eager_state[n])
                   for n in start)
        assert any(not torch.equal(after_replay[n], start[n])
                   for n in start)


@pytest.mark.cuda
def test_persistables_keep_their_addresses_across_replays(cuda):
    import paddle_tpu_torch as pt

    with fresh_port_programs():
        loss, _ = _mlp()
        main = pt.default_main_program()
        exe = pt.Executor(pt.CUDAPlace(0))
        exe.run(pt.default_startup_program())
        scope = pt.global_scope()
        prog = pt.CompiledProgram(main)
        names = [v.name for v in main.persistables() if not v.is_data]
        losses = []
        for i in range(6):
            losses.append(float(exe.run(prog, feed={"x": _mlp_x(8)},
                                        fetch_list=[loss])[0]))
            ptrs = [scope.find_var(n).get().data_ptr() for n in names]
            if i == 0:
                first = ptrs
            assert ptrs == first
        assert prog.graph_stats()["replays"] == 5
        assert losses[-1] < losses[0]


@pytest.mark.cuda
@pytest.mark.parametrize("planted,stage", [
    ("_test_sync_always", "warm-up"),
    ("_test_sync_in_capture", "capture")])
def test_a_synchronising_op_makes_run_raise(cuda, planted, stage):
    """An op that synchronises (always, so in the eager warm-up too, or
    only while a stream captures) fails the capture, the check of the
    compiled path; ``run`` raises, caches nothing, no sync-debug mode is
    left set, and the card is usable after (the interpreter runs the
    same program)."""
    import paddle_tpu_torch as pt

    _register_planted_ops()
    with fresh_port_programs():
        loss, _ = _mlp(planted=planted, train=False)
        main = pt.default_main_program()
        exe = pt.Executor(pt.CUDAPlace(0))
        exe.run(pt.default_startup_program())
        prog = pt.CompiledProgram(main)
        with pytest.raises(RuntimeError, match="capturing segment"):
            exe.run(prog, feed={"x": _mlp_x(8)}, fetch_list=[loss])
        assert prog._cache == {}
        assert torch.cuda.get_sync_debug_mode() == 0
        out, = exe.run(main, feed={"x": _mlp_x(8)}, fetch_list=[loss])
        assert np.isfinite(out).all()


@pytest.mark.cuda
def test_a_second_feed_shape_captures_a_second_graph(cuda):
    import paddle_tpu_torch as pt

    with fresh_port_programs():
        loss, hidden = _mlp(train=False)
        main = pt.default_main_program()
        exe = pt.Executor(pt.CUDAPlace(0))
        exe.run(pt.default_startup_program())
        prog = pt.CompiledProgram(main)
        graphs = []
        for batch in (8, 8, 8, 5, 5, 8):
            got = exe.run(prog, feed={"x": _mlp_x(batch)},
                          fetch_list=[loss, hidden])
            want = exe.run(main, feed={"x": _mlp_x(batch)},
                           fetch_list=[loss, hidden])
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            graphs.append(prog.graph_stats()["graphs"])
        assert graphs == [1, 1, 1, 2, 2, 2]
        assert prog.graph_stats() == {"entries": 2, "graphs": 2,
                                      "replays": 4}


def _lm_feed(batch, seed):
    ids = np.random.RandomState(seed).randint(
        0, TINY_LM["vocab_size"], (batch, TINY_LM["max_len"], 1))
    return {"src_ids": ids.astype(np.int64), "tgt_label": ids.astype(np.int64)}


@pytest.mark.cuda
def test_two_compiled_programs_capture_and_replay_side_by_side(cuda):
    """One thread builds new keys (warm-up, then a thread-local capture)
    of one CompiledProgram while another replays a second CompiledProgram
    of the same model in a loop, as two serving replicas on one card do:
    no error in either, and every result equals the serial run's bits
    for its feed."""
    import threading

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    with fresh_port_programs():
        fetch = transformer_encoder_model(**TINY_LM)["logits"].name
        main = pt.default_main_program()
        startup = pt.default_startup_program()
        batches = (1, 3, 4, 5, 6, 7, 8)
        feeds = {b: _lm_feed(b, b) for b in (2,) + batches}

        def replica():
            exe = pt.Executor(pt.CUDAPlace(0))
            scope = pt.Scope()
            np.random.seed(0)
            exe.run(startup, scope=scope)
            prog = pt.CompiledProgram(main)
            return lambda b: exe.run(prog, feed=feeds[b], scope=scope,
                                     fetch_list=[fetch])[0], prog

        serial, _ = replica()
        want = {b: serial(b) for b in feeds}
        assert all(np.array_equal(serial(b), want[b]) for b in feeds)

        replayer, rprog = replica()
        capturer, cprog = replica()
        replayer(2)                               # its one key, captured
        done, errors, replayed = threading.Event(), [], []

        def replay_loop():
            try:
                while not done.is_set() or len(replayed) < 20:
                    replayed.append(np.array_equal(replayer(2), want[2]))
            except BaseException as e:   # reported below
                errors.append(("replayer", e))

        def build_keys():
            try:
                for _ in range(2):              # warm-up + capture, replay
                    for b in batches:
                        assert np.array_equal(capturer(b), want[b]), b
            except BaseException as e:
                errors.append(("capturer", e))
            finally:
                done.set()

        threads = [threading.Thread(target=replay_loop, daemon=True),
                   threading.Thread(target=build_keys, daemon=True)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        assert replayed and all(replayed)
        assert rprog.graph_stats() == {"entries": 1, "graphs": 1,
                                       "replays": len(replayed)}
        assert cprog.graph_stats() == {"entries": len(batches),
                                       "graphs": len(batches),
                                       "replays": len(batches)}
        assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_replays_go_on_while_another_program_captures(cuda):
    """While one thread warms up and captures new keys of one
    CompiledProgram, another thread's replays of a second one of the same
    model go on: runs end inside the capture windows (the device lock
    counts them), every result equals the serial run's bits, and the
    capturing instance's graph pool holds only memory that its capture
    stream asked for (the replays and their fetches allocated none of
    it)."""
    import threading

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import compiler
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    with fresh_port_programs():
        fetch = transformer_encoder_model(**TINY_LM)["logits"].name
        main = pt.default_main_program()
        startup = pt.default_startup_program()
        batches = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12)
        feeds = {b: _lm_feed(b, 100 + b) for b in (16,) + batches}

        def replica():
            exe = pt.Executor(pt.CUDAPlace(0))
            scope = pt.Scope()
            np.random.seed(0)
            exe.run(startup, scope=scope)
            prog = pt.CompiledProgram(main)
            return lambda b: exe.run(prog, feed=feeds[b], scope=scope,
                                     fetch_list=[fetch])[0], prog

        serial, _ = replica()
        want = {b: serial(b) for b in feeds}
        replayer, rprog = replica()
        capturer, cprog = replica()
        replayer(16)                              # its one key, captured
        lock = compiler._device_lock(torch.device("cuda", 0))
        seen = len(lock.captures)
        done, errors, replayed = threading.Event(), [], []

        def replay_loop():
            try:
                while not done.is_set():
                    replayed.append(np.array_equal(replayer(16), want[16]))
            except BaseException as e:   # reported below
                errors.append(("replayer", e))

        def build_keys():
            try:
                time.sleep(0.05)
                for b in batches:
                    assert np.array_equal(capturer(b), want[b]), b
            except BaseException as e:
                errors.append(("capturer", e))
            finally:
                done.set()

        threads = [threading.Thread(target=replay_loop, daemon=True),
                   threading.Thread(target=build_keys, daemon=True)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        assert replayed and all(replayed)
        windows = list(lock.captures)[seen:]
        assert len(windows) == len(batches)
        print("runs ended in each capture window, and its ms:",
              [(n, round(s * 1e3, 2)) for s, n in windows])
        assert sum(n for _, n in windows) > 0
        assert cprog.graph_stats()["graphs"] == len(batches)
        pool = tuple(cprog._pool)
        segs = [g for g in torch.cuda.memory_snapshot()
                if tuple(g["segment_pool_id"]) == pool]
        assert segs
        assert {g["stream"] for g in segs} == {cprog._stream.cuda_stream}


# ---------------------------------------------------------------------------
# the bench's other training legs at small sizes: BERT, DeepFM, long context
# ---------------------------------------------------------------------------

# heads of 16, so the flash kernels take the model's views uncopied
TINY_BERT = dict(vocab_size=128, max_len=16, d_model=64, n_head=4,
                 d_inner=128, n_layer=2, dropout_rate=0.0)


def _leg_program(leg):
    """(loss, feed) of a small BERT or DeepFM with Adam(1e-3) in the
    default programs."""
    import paddle_tpu_torch as pt

    if leg == "bert":
        from paddle_tpu_torch.models.bert import (bert_inputs_synthetic,
                                                  bert_model)

        loss = bert_model(**TINY_BERT)["loss"]
        feed = bert_inputs_synthetic(2, TINY_BERT["max_len"],
                                     TINY_BERT["vocab_size"])
    else:
        from paddle_tpu_torch.models.deepfm import (deepfm_inputs_synthetic,
                                                    deepfm_model)

        loss = deepfm_model(vocab_size=1000, hidden=(32, 32),
                            is_sparse=False)["loss"]
        feed = deepfm_inputs_synthetic(16, vocab_size=1000)
    pt.optimizer.Adam(1e-3).minimize(loss)
    return loss, feed


def _leg_steps(place, leg, steps, compiled=False):
    """Step 1's loss and grads, then ``steps - 1`` more; the params."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import convert

    with fresh_port_programs():
        loss, feed = _leg_program(leg)
        main = pt.default_main_program()
        exe = pt.Executor(place)
        scope = pt.Scope()
        np.random.seed(0)
        exe.run(pt.default_startup_program(), scope=scope)
        params = [p.name for p in main.all_parameters()]
        prog = pt.CompiledProgram(main) if compiled else main
        first = exe.run(prog, feed=feed, scope=scope,
                        fetch_list=[loss] + [p + "@GRAD" for p in params])
        for _ in range(steps - 1):
            exe.run(prog, feed=feed, scope=scope)
        return first, convert.params_to_numpy(scope, params)


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["bert", "deepfm"])
def test_leg_steps_on_the_card_match_cpu(cuda, leg):
    """Two f32 Adam steps on the card against the CPU: the loss and every
    grad of step 1 within 1e-4, the parameters within 2*lr a step plus
    1e-4; BERT's layers each launch the flash forward twice a step (once
    more in the grad), dq and dkv once; DeepFM launches no hand kernel."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernel_launches

    before = kernel_launches()
    gpu, gpu_params = _leg_steps(pt.CUDAPlace(0), leg, 2)
    after = kernel_launches()
    n = TINY_BERT["n_layer"] if leg == "bert" else 0
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == ({
                "flash_attention_fwd": 2 * 2 * n,
                "flash_attention_bwd_dq": 2 * n,
                "flash_attention_bwd_dkv": 2 * n} if n else {})
    cpu, cpu_params = _leg_steps(pt.CPUPlace(), leg, 2)
    for g, c in zip(gpu, cpu):
        np.testing.assert_allclose(g, c, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(c).max()))
    for name in cpu_params:
        np.testing.assert_allclose(gpu_params[name], cpu_params[name],
                                   rtol=0, atol=2 * 2e-3 + 1e-4,
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["bert", "deepfm"])
def test_compiled_leg_steps_equal_interpreted_on_the_card(cuda, leg):
    """Three steps through ``CompiledProgram`` (the eager warm-up, then
    two replays) give the interpreter's bits: step 1's fetches and every
    parameter after step 3."""
    import paddle_tpu_torch as pt

    want, want_params = _leg_steps(pt.CUDAPlace(0), leg, 3)
    got, got_params = _leg_steps(pt.CUDAPlace(0), leg, 3, compiled=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for name in want_params:
        np.testing.assert_array_equal(got_params[name], want_params[name],
                                      err_msg=name)


def _longctx(heads, seq, d):
    """The bench's long-context step in the default programs; returns
    the loss."""
    import paddle_tpu_torch as pt

    qkv = []
    for n in "qkv":
        x = pt.layers.data(n, shape=[heads, seq, d], dtype="bfloat16")
        x.stop_gradient = False
        qkv.append(x)
    out = pt.layers.flash_attention(*qkv, causal=True)
    loss = pt.layers.reduce_sum(pt.layers.cast(out, "float32"))
    pt.backward.append_backward(loss)
    return loss


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_longctx_step_equals_the_autograd_function(cuda, d):
    """The long-context program at 2 heads of 512 tokens, interpreted and
    compiled: 2 forward, 1 dq and 1 dkv launches a step, no copy, and
    the loss and q/k/v@GRAD torch.equal to a direct call of the flash
    autograd Function on the same inputs; against the CPU, the grads
    within 3e-2 of max(1, their scale) (bf16 out, dS rounded to bf16 at
    other points)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernel_launches

    gen = torch.Generator().manual_seed(d)
    feed = {n: torch.randn((1, 2, 512, d), generator=gen).to(
        cuda, torch.bfloat16) for n in "qkv"}
    fetch = ["q@GRAD", "k@GRAD", "v@GRAD"]
    with fresh_port_programs():
        loss = _longctx(2, 512, d)
        main = pt.default_main_program()
        runs = {}
        for name, place, prog in (
                ("gpu", pt.CUDAPlace(0), main),
                ("compiled", pt.CUDAPlace(0), pt.CompiledProgram(main)),
                ("cpu", pt.CPUPlace(), main)):
            exe = pt.Executor(place)
            before = kernel_launches()
            runs[name] = [exe.run(prog, feed=feed, scope=pt.Scope(),
                                  fetch_list=[loss] + fetch,
                                  return_numpy=False) for _ in range(2)]
            after = kernel_launches()
            if name == "gpu":
                assert {k: after[k] - before[k] for k in after
                        if after[k] != before[k]} == {
                    "flash_attention_fwd": 4, "flash_attention_bwd_dq": 2,
                    "flash_attention_bwd_dkv": 2}
    leaves = [feed[n].detach().requires_grad_() for n in "qkv"]
    out, _ = fa.flash_attention_lse(*leaves, causal=True)
    direct_loss = torch.sum(out.float(), dim=(0, 1, 2, 3))
    direct = [direct_loss] + list(torch.autograd.grad(direct_loss, leaves))
    for run in runs["gpu"] + runs["compiled"]:
        assert all(torch.equal(x, y.detach()) for x, y in zip(run, direct))
    for g, c in zip(runs["gpu"][0][1:], runs["cpu"][0][1:]):
        c = c.float()
        assert (g.float().cpu() - c).abs().max().item() <= \
            3e-2 * max(1.0, c.abs().max().item())


# ---------------------------------------------------------------------------
# maxpool_grad_algo="compare" and BERT's f32 check
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_maxpool_compare_on_the_card_equals_the_cpu(cuda, fmt, dtype):
    """pool2d under maxpool_grad_algo="compare" on a ReLU'd input full of
    ties (the stem pool's 3x3/2/1): the card's forward and gradient are
    the CPU's bits (plain PyTorch on both: elementwise f32 adds in one
    order), and the gradient reaches more elements than "sas"'s."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.registry import get_op_def

    pdef = get_op_def("pool2d")
    attrs = pdef.canonical_attrs({
        "pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
        "paddings": [1, 1], "data_format": fmt})
    rng = np.random.RandomState(4)
    shape = (2, 17, 18, 8) if fmt == "NHWC" else (2, 8, 17, 18)
    x = torch.from_numpy(np.maximum(rng.standard_normal(shape), 0)
                         .astype(np.float32)).to(getattr(torch, dtype))

    def run(device, algo):
        pt.set_flags({"maxpool_grad_algo": algo})
        try:
            xr = x.to(device).requires_grad_()
            out = pdef.compute({"X": xr}, attrs, torch.device(device))["Out"]
            dy = torch.from_numpy(np.random.RandomState(5).standard_normal(
                tuple(out.shape)).astype(np.float32)).to(device, x.dtype)
            return out.detach().cpu(), torch.autograd.grad(out, xr, dy)[0] \
                .cpu()
        finally:
            pt.set_flags({"maxpool_grad_algo": "sas"})

    out, dx = run("cuda", "compare")
    cpu_out, cpu_dx = run("cpu", "compare")
    assert torch.equal(out, cpu_out) and torch.equal(dx, cpu_dx)
    _, sas_dx = run("cuda", "sas")
    assert int((dx != 0).sum()) > int((sas_dx != 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_bert_f32_step_sees_a_planted_flash_bwd_fault(cuda, kernel,
                                                      monkeypatch):
    """The small BERT's f32 step on the card holds every grad within 1e-4
    of its norm against the CPU, and with the last 8 rows of every
    (batch, head) of dq (or dk) zeroed after each launch of that kernel,
    some grad (a q or k projection's) moves by more than 1e-2 of its
    norm: the f32 check of chip_smoke.py's BERT phase sees such a
    fault."""
    import paddle_tpu_torch as pt

    def rel(got, want):
        return [float(np.linalg.norm(g - w)) / max(float(np.linalg.norm(w)),
                                                     1e-30)
                for g, w in zip(got[1:], want[1:])]

    cpu, _ = _leg_steps(pt.CPUPlace(), "bert", 1)
    gpu, _ = _leg_steps(pt.CUDAPlace(0), "bert", 1)
    assert max(rel(gpu, cpu)) <= 1e-4
    real = fa._bwd_kernel

    def faulty(name, q, k, v, do, lse, delta, outs, causal, scale):
        real(name, q, k, v, do, lse, delta, outs, causal, scale)
        if name == kernel:
            outs[0][:, :, -8:, :] = 0

    monkeypatch.setattr(fa, "_bwd_kernel", faulty)
    bad, _ = _leg_steps(pt.CUDAPlace(0), "bert", 1)
    assert max(rel(bad, cpu)) > 1e-2
