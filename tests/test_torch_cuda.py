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
bf16 (dS rounded to bf16 in both, at other points of the sum).  A
training step of the tiny LM on the card matches the CPU within
rtol=atol=1e-4 in the loss and every parameter grad.

The ``fc_epilogue`` kernel is held against ``fc_epilogue_plain`` over
every fc stage subset, ragged and aligned shapes, f32 and bf16.  Both
accumulate the same products in f32 in other orders (f32 within 1e-4 of
outputs of unit scale); bf16 output is one rounding of that f32 value,
so the two may differ by one bf16 step where the sums straddle a
rounding boundary (within 1e-2 + 1e-2 * |ref|).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_LM, fresh_port_programs

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
    (1, 2, 48, 48, 32, True, "bfloat16"),
    (1, 2, 37, 61, 16, True, "bfloat16"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    mm = torch.backends.cuda.matmul
    old = mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = False
    yield torch.device("cuda", 0)
    mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = old


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
    launches = fa.flash_attention_fwd.launches
    out, = gpu.run([ids.astype(np.int64)])
    assert fa.flash_attention_fwd.launches == launches + TINY_LM["n_layer"]
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
    (1, 2, 48, 48, 32, True, "bfloat16", False, False),
    (1, 2, 37, 61, 16, True, "bfloat16", True, True),
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
    CPU too."""
    q = torch.zeros((1, 1, 8, 24))
    with pytest.raises(ValueError, match="head dim 24"):
        fa._check(q, q, q)
    h = torch.zeros((1, 1, 8, 32), dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        fa._check(h, h, h)
    s = torch.zeros((1, 1, 32, 8)).transpose(2, 3)
    with pytest.raises(ValueError, match="unit stride"):
        fa._check(s, s, s)


# (M, K, N): ragged edges, K and N not multiples of 8 (the masked-load
# path), and the aligned cp.async path
FC_SHAPES = [(100, 130, 77), (1, 3, 5), (257, 64, 129), (130, 40, 136),
             (256, 512, 512), (300, 2048, 40)]
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
    rng = np.random.RandomState(m + k + n)
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
                    got = ep.fc_epilogue_kernel(x, w, bias, res, act, approx)
                    torch.cuda.synchronize()
                    assert ep.fc_epilogue.launches == launches + 1
                    want = ep.fc_epilogue_plain(x, w, bias, res, act, approx)
                    assert _fc_close(got, want, dtype), \
                        (bias_dtype, res_dtype, has_b, has_r, act, approx)


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
