#!/usr/bin/env python3
"""Drives the torch port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, none of which catches its own failure:
  1. prints the card (nvidia-smi name and power limit) and builds every
     CUDA kernel from csrc/, one nvcc per source, all started together;
  2. holds the flash-attention forward kernel against its plain PyTorch
     version on the card over a set of cases (the main paths' full-width
     shapes among them), and times the kernel, the plain version and one
     PyTorch library call;
  3. serves the Transformer-base LM (vocab 32000, d_model 512, 8 heads,
     d_inner 2048, 6 layers, seq 512, random weights from --seed) through
     save_inference_model -> create_predictor(Config(dir)) -> run, counts
     the kernel launches of those requests, and compares one request's
     logits with the same model on the CPU (Config.disable_gpu());
  4. holds the two flash-attention backward kernels (dq and dkv) against
     their plain version over the same cases plus one with an lse
     cotangent, times them beside the PyTorch pass that prepares their
     inputs (delta), the plain backward and SDPA's backward, and checks
     the autograd Function against autograd of the plain forward;
  5. trains the same LM (is_test=False, dropout 0) in f32 with
     optimizer.Adam(1e-4).minimize(loss) through Executor.run on the
     card: one warm-up step, then TRAIN_STEPS (5) counted steps at batch
     8 on one fixed batch, counting the kernel launches of those steps (12
     forward, 6 dq, 6 dkv a step), and asserts the loss is finite and
     falls; then runs that program at batch 2 on the card and on the CPU:
     the loss and every parameter grad of step 1, and every parameter
     after step 2, must agree;
  6. holds the fc_epilogue kernel against its plain version over every
     fc stage subset (and the tanh gelu) at ragged shapes in f32 and
     bf16, and at the AMP path's three shapes (M 16384: out-proj, fc1,
     fc2), times it there beside the plain version, the flag-off chain
     and torch.addmm, and checks its autograd Function;
  7. trains the LM in the bench's AMP configuration (fuse_epilogue
     anchors=("fc",), bf16 AMP with static loss scaling 1.0,
     Adam(1e-4, fuse=True), flag fc_epilogue "on") at batch 32: one
     warm-up and 5 counted steps, 36 fc_epilogue and 12/6/6 flash
     launches a step, loss finite and falling; then the batch-2 step on
     the card against the CPU (flag "interpret");
  8. profiles one request and one step of each training path (device
     busy share, top kernels), inside phases 3, 5 and 7;
  9. prints one {"kernels": [...]} line, then the card's line, then the
     result line {"ok": true, "device": {...}} last.

Takes about two minutes on one H100, the kernels' build included.

Exits non-zero, printing no result line, when no CUDA device is present
or when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Transformer-base (the JAX package's bench.py TRANSFORMER_BASE) at the
# bench's seq 512 and a serving batch of 8 requests' worth of rows.
MODEL = dict(vocab_size=32000, max_len=512, d_model=512, n_head=8,
             d_inner=2048, n_layer=6, dropout_rate=0.0, is_test=True)
BATCH = 8
# H100 SXM peaks at the full 700 W (NVIDIA data sheet): HBM bytes/s and
# dense FLOP/s by input type.  The flash kernel keeps f32 inputs in full
# f32 (TF32 off), so its f32 peak is the non-tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# f32 kernel vs plain version (both f32 accumulation, other orders);
# bf16 out carries the bf16 rounding of P and of the output.
TOL = {"float32": {"out": 1e-4, "lse": 1e-4},
       "bfloat16": {"out": 3e-2, "lse": 1e-3}}
# GPU vs CPU logits of the full model: f32 throughout with TF32 off, so
# only summation order differs across ~16 f32 reductions of width <= 2048.
LOGITS_ATOL = LOGITS_RTOL = 2e-3
ARGMAX_AGREE = 0.999
# backward kernels vs their plain version, relative to the reference's
# scale: f32 sums in other orders; bf16 rounds dS to bf16 in both, at
# points where the f32 sums already differ.
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# training: Adam at this rate on one fixed batch, seq 512
TRAIN_LR = 1e-4
# AMP training: the bench's configuration (bench.py
# _build_transformer_train: fuse_epilogue(anchors=("fc",)), bf16 AMP with
# static loss scaling 1.0, Adam(1e-4, fuse=True)) at its batch 32
AMP_BATCH = 32
TRAIN_STEPS = 5
CHECK_BATCH = 2
# GPU vs CPU training step, f32 with TF32 off on both, so sums differ
# only in order: the loss within LOSS_RTOL, and each grad within
# GRAD_BULK_RTOL of its own max magnitude in all but GRAD_BULK_SHARE of
# its elements.  Its max error may be larger: a ReLU whose input lies
# within rounding of 0 takes the other branch on the other device, and
# that changes one token's contribution to one hidden unit, about
# 1/(batch*seq) of a grad's scale (GRAD_FLIP_TOKENS tokens' worth are
# allowed).  Adam moves a weight by about lr*sign(m1) while m1 is young,
# so a grad near 0 may flip its step: parameters after two steps agree
# within 2*lr a step plus 1e-5.
LOSS_RTOL = 1e-5
GRAD_BULK_RTOL = 1e-4
GRAD_BULK_SHARE = 0.01
GRAD_FLIP_TOKENS = 5
PARAM_ATOL = 2 * 2 * TRAIN_LR + 1e-5
# AMP GPU vs CPU (CPU flag 'interpret', so both compute the fc_epilogue
# kernel's function).  The products, the casts' outputs and the
# activations are bf16, so cuBLAS, the kernels and the CPU may round a
# value one bf16 step (2^-8 relative) apart at each of those points, and
# this model at batch 2 amplifies such steps: ReLU inputs within a step
# of 0 land on the other side (or on the tie, gradient 1/2), and the
# attention grads take dP - delta, a difference of near-equal terms.  A
# second CPU run with flag 'off' (the chain: the same function, rounded
# at other points) shows that spread beside the check, in the same
# units.  The loss within AMP_LOSS_RTOL; each grad within
# AMP_GRAD_NORM_RTOL of its norm, within AMP_GRAD_BULK_RTOL of its scale
# in all but AMP_GRAD_BULK_SHARE of its elements and within
# AMP_GRAD_MAX_RTOL everywhere: about twice the two CPU runs' spread;
# a wrong grad is off by its own size.  Parameters (f32 master weights)
# as in the f32 check.
AMP_LOSS_RTOL = 1e-3
AMP_GRAD_NORM_RTOL = 0.15
AMP_GRAD_BULK_RTOL = 3e-2
AMP_GRAD_BULK_SHARE = 0.15
AMP_GRAD_MAX_RTOL = 0.3
# fc_epilogue kernel vs its plain version, relative to max(1, |ref|):
# f32 sums in other orders; bf16 output is one rounding of f32 sums
# taken in other orders, so the two may sit one bf16 step apart.
FC_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# every stage subset at ragged shapes (M, K, N): masked loads, and K, N
# multiples of 8 (the cp.async path) with ragged tiles
FC_ODD_SHAPES = [(100, 130, 77), (257, 64, 136)]
# the AMP path's three fc_epilogue calls a layer, M = AMP_BATCH * 512
FC_MAIN = [("out_proj", 512, 512, "residual"),
           ("fc1", 512, 2048, "bias+relu"),
           ("fc2", 2048, 512, "bias+residual")]


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: flash_attention_fwd against its plain version
# ---------------------------------------------------------------------------

# (B, H, Tq, Tk, D, causal, dtype, strided): strided q/k/v are permuted
# views of [B, T, H, D] tensors, as the model's transpose2 hands them over
FLASH_CASES = [
    (2, 4, 128, 128, 64, True, "float32", False),
    (2, 4, 128, 128, 64, False, "float32", False),
    (2, 3, 100, 228, 64, True, "float32", False),
    (1, 2, 200, 77, 128, True, "float32", False),
    (2, 4, 130, 130, 128, False, "float32", False),
    (1, 2, 64, 96, 32, False, "float32", True),
    (2, 4, 128, 256, 64, True, "bfloat16", False),
    (1, 2, 97, 97, 128, False, "bfloat16", False),
    (BATCH, 8, 512, 512, 64, True, "float32", True),
    (BATCH, 8, 512, 512, 64, True, "bfloat16", True),
    (AMP_BATCH, 8, 512, 512, 64, True, "bfloat16", True),
]
MAIN_CASE = FLASH_CASES[-3]
AMP_CASE = FLASH_CASES[-1]


# kernel -> (Tq x Tk x D products, [B,H,Tq,D] tensors moved, [B,H,Tk,D]
# tensors moved, f32 [B*H,Tq] vectors moved)
FLASH_WORK = {
    "fwd": (2, 2, 2, 1),    # QK^T, PV; q, out; k, v; lse
    "dq": (3, 3, 2, 2),     # S, dP, dQ; q, dO, dq; k, v; lse, delta
    "dkv": (4, 2, 4, 2),    # S, dP, dV, dK; q, dO; k, v, dk, dv; lse, delta
}


def flash_bound_ms(b, h, tq, tk, d, causal, dtype, kernel="fwd"):
    """Least time for the work: each input read once and each output
    written once over HBM, or the FLOPs (2 per multiply-add of each
    Tq x Tk x D product, halved when causal) at the card's peak for the
    input type, whichever is larger."""
    products, n_q, n_k, n_vec = FLASH_WORK[kernel]
    elem = 4 if dtype == "float32" else 2
    nbytes = elem * b * h * d * (n_q * tq + n_k * tk) + 4 * n_vec * b * h * tq
    flops = 2.0 * products * b * h * tq * tk * d * (0.5 if causal else 1.0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def check_flash(device, seed):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed)
    results = []
    for (b, h, tq, tk, d, causal, dtype, strided) in FLASH_CASES:
        tdtype = getattr(torch, dtype)

        def make(t):
            x = torch.from_numpy(rng.standard_normal(
                (b, t, h, d)).astype(np.float32))
            x = x.to(device=device, dtype=tdtype)
            x = x.permute(0, 2, 1, 3)
            return x if strided else x.contiguous()

        q, k, v = make(tq), make(tk), make(tk)
        scale = 1.0 / math.sqrt(d)
        out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal,
                                                        scale)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ok = err_out <= TOL[dtype]["out"] and err_lse <= TOL[dtype]["lse"]
        iters = 20 if tq * tk >= 512 * 512 else 50
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal, scale),
                     iters)
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_fwd_plain(q, k, v, causal, scale),
            iters)
        mask = fa._causal_mask(tq, tk, device) if causal and tq != tk \
            else None
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            scale=scale), iters)
        bound_ms, bound_by = flash_bound_ms(b, h, tq, tk, d, causal, dtype)
        row = dict(shape=[b, h, tq, tk, d], causal=causal, dtype=dtype,
                   strided=strided, max_abs_err_out=err_out,
                   max_abs_err_lse=err_lse, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, ok=ok)
        log("flash case " + json.dumps(row))
        if not ok:
            raise AssertionError(
                f"flash_attention_fwd disagrees with its plain version: "
                f"{row}")
        results.append(row)
    return results


# ---------------------------------------------------------------------------
# phase 4: the backward kernels (dq, dkv) against their plain version
# ---------------------------------------------------------------------------

# the forward's cases, plus one with a cotangent of lse (the last flag)
BWD_CASES = [c + (False,) for c in FLASH_CASES] + [
    (2, 3, 100, 228, 64, True, "float32", True, True)]
BWD_MAIN_CASE = BWD_CASES[len(FLASH_CASES) - 3]
BWD_AMP_CASE = BWD_CASES[len(FLASH_CASES) - 1]


def sdpa_bwd_ms(q, k, v, do, causal, scale, iters):
    """SDPA's backward: forward plus autograd.grad through SDPA, less
    SDPA's forward alone."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    tq, tk = q.shape[2], k.shape[2]
    mask = fa._causal_mask(tq, tk, q.device) if causal and tq != tk \
        else None
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=causal and mask is None,
            scale=scale)

    fwd_ms = cuda_ms(fwd, iters)
    both_ms = cuda_ms(lambda: torch.autograd.grad(fwd(), leaves, do), iters)
    return both_ms - fwd_ms


def check_flash_bwd(device, seed):
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed + 3)
    results = []
    for (b, h, tq, tk, d, causal, dtype, strided, with_dlse) in BWD_CASES:
        tdtype = getattr(torch, dtype)

        def make(t):
            x = torch.from_numpy(rng.standard_normal(
                (b, t, h, d)).astype(np.float32))
            x = x.to(device=device, dtype=tdtype).permute(0, 2, 1, 3)
            return x if strided else x.contiguous()

        q, k, v, do = make(tq), make(tk), make(tk), make(tq)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        dlse = None
        if with_dlse:
            dlse = torch.from_numpy(rng.standard_normal(
                (b * h, tq)).astype(np.float32)).to(device)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale,
                                       dlse)
        torch.cuda.synchronize()
        refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                            scale, dlse)
        errs, ok = {}, True
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            errs[name] = (g.float() - r.float()).abs().max().item()
            ref_max = r.float().abs().max().item()
            ok &= bool(g.float().isfinite().all()) and \
                errs[name] <= BWD_TOL[dtype] * max(1.0, ref_max)
        if causal and tq > tk:     # rows that see no key: dq exactly 0
            ok &= bool((grads[0][:, :, :tq - tk] == 0).all())
        iters = 10 if tq * tk >= 512 * 512 else 30
        do_c, lse_c, delta = fa._bwd_prepare(q, k, v, o, lse, do, dlse)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        ms = {
            "dq": cuda_ms(lambda: fa._bwd_kernel(
                "dq", q, k, v, do_c, lse_c, delta, (dq,), causal, scale),
                iters),
            "dkv": cuda_ms(lambda: fa._bwd_kernel(
                "dkv", q, k, v, do_c, lse_c, delta, (dk, dv), causal,
                scale), iters),
        }
        # the PyTorch pass outside the kernels: delta = rowsum(dO*O) -
        # dlse, and a copy of a dO without a unit-stride head dim
        prepare_ms = cuda_ms(lambda: fa._bwd_prepare(q, k, v, o, lse, do,
                                                     dlse), iters)
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal, scale, dlse), iters)
        library_ms = sdpa_bwd_ms(q, k, v, do, causal, scale, iters)
        bounds = {n: flash_bound_ms(b, h, tq, tk, d, causal, dtype, n)
                  for n in ("dq", "dkv")}
        row = dict(shape=[b, h, tq, tk, d], causal=causal, dtype=dtype,
                   strided=strided, dlse=with_dlse, max_abs_err=errs,
                   ms=ms, prepare_ms=prepare_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms={n: v[0] for n, v in bounds.items()},
                   bound_by={n: v[1] for n, v in bounds.items()}, ok=ok)
        log("flash bwd case " + json.dumps(row))
        if not ok:
            raise AssertionError(
                f"flash_attention_bwd disagrees with its plain version: "
                f"{row}")
        results.append(row)

    # the autograd Function against autograd of the plain forward
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 4, 96, 64)).astype(np.float32)).to(device) for _ in range(4))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(
        fa.flash_attention_lse(*leaves, causal=True)[0], leaves, do)
    want = torch.autograd.grad(
        fa.flash_attention_fwd_plain(*leaves, True, 1 / 8.0)[0], leaves, do)
    err = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
              for g, w in zip(got, want))
    log(f"FlashAttention.apply vs autograd of the plain forward: max "
        f"scaled err {err:.3e}")
    if err > BWD_TOL["float32"]:
        raise AssertionError("FlashAttention's grads disagree with "
                             "autograd of the plain forward")
    return results


# ---------------------------------------------------------------------------
# phase 6: the fc_epilogue kernel against its plain version
# ---------------------------------------------------------------------------

def fc_times(m, k, n, spec, dtype):
    """(bytes ms, operations ms) of act(x.w + bias + residual): x, w,
    bias and residual read once and out written once over HBM; 2*M*K*N
    operations at the card's peak for the input type."""
    elem = 4 if dtype == "float32" else 2
    nbytes = elem * (m * k + k * n + m * n)
    nbytes += elem * n * ("bias" in spec) + elem * m * n * ("residual" in spec)
    return (nbytes / PEAK_BYTES_PER_S * 1e3,
            2.0 * m * k * n / PEAK_FLOPS[dtype] * 1e3)


def fc_bound_ms(m, k, n, spec, dtype):
    t_bytes, t_ops = fc_times(m, k, n, spec, dtype)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def fc_operands(rng, device, m, k, n, spec, dtype):
    """x [M,K] and bias, residual ~ N(0, 1); w [K,N] ~ N(0, 1/K), so the
    outputs are of unit scale at every K."""
    import torch

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device,
                                                        getattr(torch, dtype))

    x, w = t((m, k), 1.0), t((k, n), k ** -0.5)
    bias = t((n,), 1.0) if "bias" in spec else None
    res = t((m, n), 1.0) if "residual" in spec else None
    return x, w, bias, res


def fc_err(got, want):
    """max |got - want| / max(1, |want|), in f32."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() / max(
        1.0, want.abs().max().item())


def check_fc_epilogue(device, seed):
    """Every fc stage subset (and the tanh gelu) at ragged shapes, f32
    and bf16; the main path's three shapes, held and timed beside the
    plain version and the flag-off chain (cuBLAS product, then each add
    and the act), and torch.addmm (product plus one add in one call);
    the autograd Function's grads against autograd of the chain."""
    import torch

    from paddle_tpu_torch.ops import epilogue as ep

    rng = np.random.RandomState(seed + 4)
    acts = [(s.to_attr(), s.act, False) for s in ep.enumerate_specs("fc")]
    acts += [(a, act, True) for a, act, _ in acts if act == "gelu"]
    worst = {}
    for dtype in ("float32", "bfloat16"):
        for m, k, n in FC_ODD_SHAPES:
            for attr, act, approx in acts:
                x, w, b, r = fc_operands(rng, device, m, k, n, attr, dtype)
                got = ep.fc_epilogue_kernel(x, w, b, r, act, approx)
                torch.cuda.synchronize()
                err = fc_err(got, ep.fc_epilogue_plain(x, w, b, r, act,
                                                       approx))
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if not (err <= FC_TOL[dtype] and got.dtype == x.dtype):
                    raise AssertionError(
                        f"fc_epilogue disagrees with its plain version: "
                        f"{(m, k, n)} {dtype} {attr!r} approximate="
                        f"{approx}: {err:.3e}")
    log(f"fc_epilogue over {2 * len(FC_ODD_SHAPES) * len(acts)} ragged "
        f"cases: worst scaled err {json.dumps(worst)}")

    rows = []
    m = AMP_BATCH * MODEL["max_len"]
    for name, k, n, attr in FC_MAIN:
        act = ep.EpilogueSpec.from_attr(attr).act
        for dtype in ("float32", "bfloat16"):
            x, w, b, r = fc_operands(rng, device, m, k, n, attr, dtype)
            got = ep.fc_epilogue_kernel(x, w, b, r, act)
            torch.cuda.synchronize()
            want = ep.fc_epilogue_plain(x, w, b, r, act, False)
            err = fc_err(got, want)
            if err > FC_TOL[dtype]:
                raise AssertionError(f"fc_epilogue disagrees with its plain "
                                     f"version at {name} {dtype}: {err:.3e}")
            if dtype == "float32":     # the f32 kernel, off the AMP path
                ms = cuda_ms(lambda: ep.fc_epilogue_kernel(x, w, b, r, act),
                             20)
                log(f"fc_epilogue {name} f32: scaled err {err:.3e}, "
                    f"ms {ms:.4f}")
                continue
            addend = r if b is None else b
            bound_ms, bound_by = fc_bound_ms(m, k, n, attr, dtype)
            row = dict(
                name=name, shape=[m, k, n], epilogue=attr, dtype=dtype,
                max_abs_err=(got.float() - want.float()).abs().max().item(),
                scaled_err=err,
                ms=cuda_ms(lambda: ep.fc_epilogue_kernel(x, w, b, r, act),
                           50),
                plain_ms=cuda_ms(lambda: ep.fc_epilogue_plain(
                    x, w, b, r, act, False), 20),
                chain_ms=cuda_ms(lambda: ep._fc_reference(
                    x, w, b, r, act, False), 50),
                addmm_ms=cuda_ms(lambda: torch.addmm(addend, x, w), 50),
                bound_ms=bound_ms, bound_by=bound_by)
            row["tflops"] = 2.0 * m * k * n / row["ms"] / 1e9
            log("fc_epilogue case " + json.dumps(row))
            rows.append(row)

    # the autograd Function: kernel forward, backward = autograd of the
    # chain, so its grads equal the chain's exactly
    for dtype in ("float32", "bfloat16"):
        x, w, b, r = fc_operands(rng, device, 96, 64, 80, "bias+residual",
                                 dtype)
        g = torch.from_numpy(rng.standard_normal((96, 80)).astype(
            np.float32)).to(device, x.dtype)
        leaves = [t.detach().requires_grad_() for t in (x, w, b, r)]
        got = torch.autograd.grad(ep.fc_epilogue(*leaves, act="gelu"),
                                  leaves, g)
        leaves = [t.detach().requires_grad_() for t in (x, w, b, r)]
        want = torch.autograd.grad(
            ep._fc_reference(*leaves, "gelu", False), leaves, g)
        if not all(torch.equal(a, e) for a, e in zip(got, want)):
            raise AssertionError(f"FcEpilogue's grads ({dtype}) differ "
                                 "from autograd of the chain")
    log("FcEpilogue.apply grads equal autograd of the chain (f32, bf16)")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path — serving the LM through the Predictor
# ---------------------------------------------------------------------------

def serve(seed, runs, workdir):
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    t0 = time.perf_counter()
    model = transformer_encoder_model(**MODEL)
    exe = pt.Executor(pt.CUDAPlace(0))
    np.random.seed(seed)
    exe.run(pt.default_startup_program())
    pt.io.save_inference_model(workdir, ["src_ids"], [model["logits"]], exe)
    log(f"model built and saved in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    pred = pt.inference.create_predictor(pt.inference.Config(workdir))
    op_types = sorted({op.type for op in pred._program.global_block().ops})
    log(f"predictor on {pred.device} in {time.perf_counter() - t0:.1f} s; "
        f"op types {op_types}")
    rng = np.random.RandomState(seed + 1)
    shape = (BATCH, MODEL["max_len"], 1)
    requests = [rng.randint(0, MODEL["vocab_size"], shape).astype(np.int64)
                for _ in range(runs)]
    first, = pred.run([requests[0]])            # warm-up, not counted

    reset_kernel_counts()
    times = []
    for ids in requests:
        t = time.perf_counter()
        logits, = pred.run([ids])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = kernel_counts()
    expected = {"flash_attention_fwd": MODEL["n_layer"] * runs,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "fc_epilogue": 0}
    log(f"kernel launches over {runs} requests: {launches}")
    if launches != expected:
        raise AssertionError(f"serving launched {launches}, expected "
                             f"{expected}")

    want = (BATCH, MODEL["max_len"], MODEL["vocab_size"])
    if first.shape != want or not np.isfinite(first).all():
        raise AssertionError(f"logits shape {first.shape} (want {want}) "
                             "or non-finite values")

    cfg = pt.inference.Config(workdir)
    cfg.disable_gpu()
    cpu_pred = pt.inference.create_predictor(cfg)
    t = time.perf_counter()
    cpu_logits, = cpu_pred.run([requests[0]])
    cpu_s = time.perf_counter() - t
    err = float(np.abs(first - cpu_logits).max())
    close = bool(np.allclose(first, cpu_logits, atol=LOGITS_ATOL,
                             rtol=LOGITS_RTOL))
    agree = float((first.argmax(-1) == cpu_logits.argmax(-1)).mean())
    log(f"GPU vs CPU logits: max abs err {err:.3e} (scale "
        f"{float(np.abs(cpu_logits).max()):.3f}), allclose(atol=rtol="
        f"{LOGITS_ATOL}) {close}, argmax agreement {agree:.6f}; "
        f"CPU request {cpu_s:.2f} s")
    if not close or agree < ARGMAX_AGREE:
        raise AssertionError("GPU logits disagree with the CPU run")

    total = sum(times)
    tokens = BATCH * MODEL["max_len"]
    serving = dict(requests=runs, batch=BATCH, seq=MODEL["max_len"],
                   request_ms=[t * 1e3 for t in times],
                   requests_per_s=runs / total,
                   tokens_per_s=runs * tokens / total,
                   logits_max_abs_err_vs_cpu=err, argmax_agreement=agree)
    log("serving " + json.dumps(serving))
    profile("request", lambda: pred.run([requests[0]]))
    return launches, serving


# ---------------------------------------------------------------------------
# phases 5 and 7: the main paths — training the LM, in f32 and under AMP
# ---------------------------------------------------------------------------

def build_train_program():
    """The LM in training mode with Adam appended, in programs of its
    own.  Returns (model, main, startup, params_grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = transformer_encoder_model(**dict(MODEL, is_test=False))
        _, params_grads = pt.optimizer.Adam(TRAIN_LR).minimize(
            model["loss"])
    return model, main, startup, params_grads


def build_amp_program():
    """The bench's AMP training configuration, in programs of its own:
    fuse_epilogue(anchors=("fc",)) before minimize, then Adam(TRAIN_LR,
    fuse=True) under decorate(init_loss_scaling=1.0,
    use_dynamic_loss_scaling=False).  Asserts one fused_adam op, no adam
    op and three fc_epilogue ops a layer."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = transformer_encoder_model(**dict(MODEL, is_test=False))
        pt.transpiler.fuse_epilogue(main, protected=[model["loss"].name],
                                    anchors=("fc",))
        opt = decorate(pt.optimizer.Adam(TRAIN_LR, fuse=True),
                       init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(model["loss"])
    types = [op.type for op in main.global_block().ops]
    if (types.count("fused_adam"), types.count("adam"),
            types.count("fc_epilogue")) != (1, 0, 3 * MODEL["n_layer"]):
        raise AssertionError("the AMP program does not hold one fused_adam "
                             "op, no adam op and 3 fc_epilogue ops a layer")
    return model, main, startup, params_grads


@contextlib.contextmanager
def fc_epilogue_flag(mode):
    from paddle_tpu_torch.flags import set_flags

    set_flags({"fc_epilogue": mode})
    try:
        yield
    finally:
        set_flags({"fc_epilogue": "off"})


def train_batch(seed, batch):
    rng = np.random.RandomState(seed + 2)
    shape = (batch, MODEL["max_len"], 1)
    return {n: rng.randint(0, MODEL["vocab_size"], shape).astype(np.int64)
            for n in ("src_ids", "tgt_label")}


def kernel_counts():
    from paddle_tpu_torch.ops import epilogue as ep
    from paddle_tpu_torch.ops import flash_attention as fa

    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd.launches["dq"],
            "flash_attention_bwd_dkv":
                fa.flash_attention_bwd.launches["dkv"],
            "fc_epilogue": ep.fc_epilogue.launches}


def reset_kernel_counts():
    from paddle_tpu_torch.ops import epilogue as ep
    from paddle_tpu_torch.ops import flash_attention as fa

    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = {"dq": 0, "dkv": 0}
    ep.fc_epilogue.launches = 0


def train(seed, built, batch, what):
    """One warm-up step, then TRAIN_STEPS counted steps of ``built`` on
    one fixed batch, counting the kernel launches of those steps: per
    step 12 flash forward (6 recomputed in the grads), 6 dq, 6 dkv, and
    each fc_epilogue op twice (once more in its grad)."""
    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    model, main, startup, params_grads = built
    types = [op.type for op in main.global_block().ops]
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    np.random.seed(seed)
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape)) for p, _ in params_grads)
    log(f"{what} program: {len(types)} ops ({types.count('adam')} adam, "
        f"{types.count('fused_adam')} fused_adam, "
        f"{types.count('fc_epilogue')} fc_epilogue, {types.count('cast')} "
        f"cast, {sum(t.endswith('_grad') for t in types)} grad ops), "
        f"{n_params} parameters; initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    feed = train_batch(seed, batch)

    def step():
        return float(exe.run(main, feed=feed, fetch_list=[model["loss"]],
                             scope=scope)[0])

    warm_loss = step()                           # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        losses.append(step())                    # the fetch synchronises
        times.append(time.perf_counter() - t)
    launches = kernel_counts()
    n = MODEL["n_layer"]
    expected = {"flash_attention_fwd": 2 * n * TRAIN_STEPS,
                "flash_attention_bwd_dq": n * TRAIN_STEPS,
                "flash_attention_bwd_dkv": n * TRAIN_STEPS,
                "fc_epilogue": 2 * types.count("fc_epilogue") * TRAIN_STEPS}
    log(f"kernel launches over {TRAIN_STEPS} {what} steps: {launches}")
    if launches != expected:
        raise AssertionError(f"{what} launched {launches}, expected "
                             f"{expected}")
    if not (np.isfinite([warm_loss] + losses).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: loss not finite or not falling: "
                             f"{[warm_loss] + losses}")
    leaked = [nm for nm, v in scope.vars.items()
              if isinstance(v.get(), torch.Tensor) and v.get().requires_grad]
    if leaked:
        raise AssertionError(f"scope tensors keep autograd state: "
                             f"{leaked[:5]}")
    tokens = batch * MODEL["max_len"]
    training = dict(steps=TRAIN_STEPS, batch=batch, seq=MODEL["max_len"],
                    lr=TRAIN_LR, warmup_loss=warm_loss, losses=losses,
                    step_ms=[t * 1e3 for t in times],
                    tokens_per_s=TRAIN_STEPS * tokens / sum(times),
                    max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                    / 1e9)
    log(f"{what} " + json.dumps(training))
    profile(f"{what} step", step)
    return launches, training


def train_and_fetch(place, seed, model, main, startup, params_grads):
    """Step 1 (fetching the loss and every parameter grad), then step 2;
    returns (loss, {grad: ndarray}, {param: ndarray after step 2})."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import convert

    exe = pt.Executor(place)
    scope = pt.Scope()
    np.random.seed(seed)
    exe.run(startup, scope=scope)
    feed = train_batch(seed, CHECK_BATCH)
    grads = [g.name for _, g in params_grads]
    out = exe.run(main, feed=feed, fetch_list=[model["loss"]] + grads,
                  scope=scope)
    exe.run(main, feed=feed, scope=scope)
    params = convert.params_to_numpy(scope, [p.name for p, _ in
                                             params_grads])
    return float(out[0]), dict(zip(grads, out[1:])), params


def step_spread(a, b, bulk_rtol):
    """How far run ``a`` (loss, grads, params) is from run ``b``: the
    loss's relative error, each grad's (max error / b's scale, share of
    elements beyond bulk_rtol of that scale, norm of the error / b's
    norm, name) worst first, and the parameters' max abs error."""
    rows = []
    for n, want in b[1].items():
        diff = np.abs(a[1][n] - want)
        scale = max(float(np.abs(want).max()), 1e-30)
        norm = max(float(np.linalg.norm(want)), 1e-30)
        rows.append((float(diff.max()) / scale,
                     float((diff > bulk_rtol * scale).mean()),
                     float(np.linalg.norm(diff)) / norm, n))
    rows.sort(reverse=True)
    param_err = max(float(np.abs(a[2][n] - b[2][n]).max()) for n in b[2])
    return abs(a[0] - b[0]) / abs(b[0]), rows, param_err


def spread_summary(spread):
    loss_err, rows, param_err = spread
    return dict(loss_rel_err=loss_err,
                worst_grads=[{"name": n, "max_err_rel_to_scale": e,
                              "share_beyond_bulk_tol": f,
                              "norm_rel_err": r} for e, f, r, n in rows[:4]],
                max_share_beyond_bulk_tol=max(r[1] for r in rows),
                max_norm_rel_err=max(r[2] for r in rows),
                max_param_abs_err_after_2_steps=param_err)


def train_gpu_vs_cpu(seed, built, what, tol, flags=("off", "off"),
                     cpu_reference_flag=None):
    """The same program from the same seed at batch CHECK_BATCH on the
    card and on the CPU (fc_epilogue flag ``flags[0]`` and ``flags[1]``):
    the step-1 loss and grads and the parameters after step 2, within
    ``tol`` (loss_rtol, bulk_rtol, bulk_share, max_rtol and, where
    given, norm_rtol).  With ``cpu_reference_flag`` a second CPU run
    under that flag shows, beside it, how far two CPU runs that round at
    other points are apart."""
    import paddle_tpu_torch as pt

    runs, secs = {}, {}
    for name, place, flag in (("gpu", pt.CUDAPlace(0), flags[0]),
                              ("cpu", pt.CPUPlace(), flags[1]),
                              ("cpu_reference", pt.CPUPlace(),
                               cpu_reference_flag)):
        if flag is None:
            continue
        t = time.perf_counter()
        with fc_epilogue_flag(flag):
            runs[name] = train_and_fetch(place, seed, *built)
        secs[name] = time.perf_counter() - t
    loss_err, grad_rows, param_err = spread = step_spread(
        runs["gpu"], runs["cpu"], tol["bulk_rtol"])
    res = dict(batch=CHECK_BATCH, flags=flags, loss_gpu=runs["gpu"][0],
               loss_cpu=runs["cpu"][0], grads=len(grad_rows),
               **spread_summary(spread), tol=tol, seconds=secs)
    if "cpu_reference" in runs:
        res["cpu_reference"] = dict(flag=cpu_reference_flag, **spread_summary(
            step_spread(runs["cpu_reference"], runs["cpu"],
                        tol["bulk_rtol"])))
    log(f"{what} GPU vs CPU " + json.dumps(res))
    if loss_err > tol["loss_rtol"] or param_err > PARAM_ATOL or any(
            e > tol["max_rtol"] or f > tol["bulk_share"]
            or r > tol.get("norm_rtol", 1.0) for e, f, r, _ in grad_rows):
        raise AssertionError(f"the GPU {what} step disagrees with the CPU "
                             "run")
    return res


def profile(what, fn):
    """Device time of one call of ``fn`` (a request, a training step) by
    kernel or copy (torch.profiler), counting only the events that ran
    on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    log(f"profile of one {what} " + json.dumps({
        "wall_ms": wall_ms, "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
        "top": [{"ms": ms, "calls": n, "name": name[:80]}
                for ms, n, name in rows[:12]]}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5,
                    help="requests served in the counted window")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch import _build

    mm = torch.backends.cuda.matmul
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")

    t0 = time.perf_counter()
    logs = _build.build(["flash_attention_fwd", "flash_attention_bwd",
                         "fc_epilogue"])
    for name, text in logs.items():
        log(f"nvcc {name}.cu:\n{text.strip()}")
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    cases = check_flash(device, args.seed)
    with tempfile.TemporaryDirectory() as workdir:
        serve_launches, _ = serve(args.seed, args.runs, workdir)
    bwd_cases = check_flash_bwd(device, args.seed)
    train_launches, _ = train(args.seed, build_train_program(), BATCH,
                              "training")
    train_gpu_vs_cpu(args.seed, build_train_program(), "training", dict(
        loss_rtol=LOSS_RTOL, bulk_rtol=GRAD_BULK_RTOL,
        bulk_share=GRAD_BULK_SHARE,
        max_rtol=GRAD_FLIP_TOKENS / (CHECK_BATCH * MODEL["max_len"])))
    fc_rows = check_fc_epilogue(device, args.seed)
    with fc_epilogue_flag("on"):
        amp_launches, _ = train(args.seed, build_amp_program(), AMP_BATCH,
                                "AMP training")
    train_gpu_vs_cpu(args.seed, build_amp_program(), "AMP training", dict(
        loss_rtol=AMP_LOSS_RTOL, bulk_rtol=AMP_GRAD_BULK_RTOL,
        bulk_share=AMP_GRAD_BULK_SHARE, max_rtol=AMP_GRAD_MAX_RTOL,
        norm_rtol=AMP_GRAD_NORM_RTOL),
        flags=("on", "interpret"), cpu_reference_flag="off")

    def row_of(rows, case):
        return next(r for r in rows if r["shape"] == list(case[:5])
                    and r["dtype"] == case[6])

    main_row, amp_row = row_of(cases, MAIN_CASE), row_of(cases, AMP_CASE)
    bwd_row = row_of(bwd_cases, BWD_MAIN_CASE)
    bwd_amp = row_of(bwd_cases, BWD_AMP_CASE)

    def by_path(name):
        return {"serving": serve_launches[name],
                "training": train_launches[name],
                "amp_training": amp_launches[name]}

    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:186",
        "launches": train_launches["flash_attention_fwd"],
        "launches_by_path": by_path("flash_attention_fwd"),
        "max_abs_err": main_row["max_abs_err_out"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "amp_path": {k: amp_row[k] for k in (
            "shape", "dtype", "max_abs_err_out", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")},
    }]
    for name, line, errs in (("dq", 409, ("dq",)),
                             ("dkv", 458, ("dk", "dv"))):
        kernels.append({
            "name": f"flash_attention_bwd_{name}", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/ops/pallas_kernels.py:{line}",
            "launches": train_launches[f"flash_attention_bwd_{name}"],
            "launches_by_path": by_path(f"flash_attention_bwd_{name}"),
            "max_abs_err": max(bwd_row["max_abs_err"][e] for e in errs),
            "ms": bwd_row["ms"][name], "plain_ms": bwd_row["plain_ms"],
            "bound_ms": bwd_row["bound_ms"][name],
            "bound_by": bwd_row["bound_by"][name],
            "library_ms": bwd_row["library_ms"],
            "amp_path": {
                "shape": bwd_amp["shape"], "dtype": bwd_amp["dtype"],
                "max_abs_err": max(bwd_amp["max_abs_err"][e] for e in errs),
                "ms": bwd_amp["ms"][name], "plain_ms": bwd_amp["plain_ms"],
                "bound_ms": bwd_amp["bound_ms"][name],
                "bound_by": bwd_amp["bound_by"][name],
                "library_ms": bwd_amp["library_ms"]},
        })
    # fc_epilogue: one layer's three calls on the AMP path, summed; the
    # library route is the flag-off chain (no one PyTorch call adds a
    # bias and a residual and applies relu)
    t_bytes, t_ops = (sum(t) for t in zip(*(
        fc_times(*r["shape"], r["epilogue"], r["dtype"]) for r in fc_rows)))
    kernels.append({
        "name": "fc_epilogue", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fc_epilogue.cu",
        "replaces": "paddle_tpu/ops/epilogue.py:370",
        "launches": amp_launches["fc_epilogue"],
        "launches_by_path": by_path("fc_epilogue"),
        "max_abs_err": max(r["max_abs_err"] for r in fc_rows),
        "ms": sum(r["ms"] for r in fc_rows),
        "plain_ms": sum(r["plain_ms"] for r in fc_rows),
        "bound_ms": sum(r["bound_ms"] for r in fc_rows),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(r["chain_ms"] for r in fc_rows),
        "shapes": {r["name"]: {k: r[k] for k in (
            "shape", "epilogue", "ms", "plain_ms", "chain_ms", "addmm_ms",
            "bound_ms", "bound_by", "tflops")} for r in fc_rows},
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"device: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
