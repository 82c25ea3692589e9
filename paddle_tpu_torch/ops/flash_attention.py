"""Flash attention: the CUDA kernels, their plain versions, the op.

Forward: replaces ``paddle_tpu/ops/pallas_kernels.py::_fwd_kernel``
(wrapper ``_flash_fwd_pallas``): blockwise ``S = Q K^T * scale`` with an
online softmax, returning ``out [B,H,Tq,D]`` in q's dtype and the
per-row ``lse = m + log l`` as ``[B*H, Tq]`` f32 (unpadded).  Causal
masking is bottom-right aligned (``q_off = Tk - Tq``); a fully masked
row outputs 0 and gets ``lse = -1e30``.

Backward: replaces ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (wrapper
``_flash_bwd_pallas``).  P is recomputed from lse,
``delta = rowsum(dO*O) - dlse`` (computed here in PyTorch, as the JAX
package computes it in XLA), ``dS = P*(dO V^T - delta)*scale``, and
``dQ = dS K``, ``dK = dS^T Q``, ``dV = P^T dO`` in f32, written in the
input dtype.  With bf16 inputs dS is rounded to bf16 before the two
products with it and P stays f32, as in the Pallas kernels.

The kernels are ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``; their headers say how they are laid
out on the card and what bounds them.  The Mosaic-only layouts of the
TPU kernels (lane-replicated or packed stats, head packing) are gone.

``flash_attention_fwd`` and ``flash_attention_bwd`` dispatch on the
device of ``q``: a CUDA tensor launches the kernels (a build or launch
failure raises), a CPU or meta tensor takes the plain version.  Each
kernel's launches are counted: ``flash_attention_fwd.launches``,
``flash_attention_bwd.launches["dq"]`` and ``["dkv"]``.  The kernels
copy their tiles 16 bytes at a time, so a q, k, v (or dO) whose rows
are not 16-byte aligned, or whose head dim has a non-unit stride, is
copied to a contiguous tensor first and counted in
``flash_attention_fwd.copies`` or ``flash_attention_bwd.copies`` (the
model's permuted ``[B,T,H,D]`` views are aligned).  The kernels take
head dims that are multiples of 16, of any size (the tensor-core tiles
up to 128, the wide tile of ``csrc/flash_wide.cuh`` above, in
256-column slices past 256); any other D is zero-padded to the next
multiple of 16 (``_pad_head``, counted in the same ``copies``): zero
columns add nothing to Q K^T, the scale stays 1/sqrt(D) of the
unpadded D, and the outputs' padded columns are sliced off.  The
plain backward also runs sliced (dq of some q rows, dk/dv of some keys,
summed in chunks), which checks the kernels at 32768 tokens.

``FlashAttention`` is the ``torch.autograd.Function`` over the pair;
the ``flash_attention`` op's compute goes through it, so the
synthesised ``flash_attention_grad`` reaches the backward kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.observability import device_trace as _obs_device
from paddle_tpu_torch.observability import tracing as _obs_trace

_NEG_INF = -1e30
_KERNEL = "flash_attention_fwd"
_BWD_KERNEL = "flash_attention_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels take D a multiple of _HEAD_DIM_STEP
_HEAD_DIM_STEP = 16


def _causal_mask(tq, tk, device):
    """[Tq, Tk] bool, True where query i may see key j: the causal band
    aligned bottom-right (``q_off = Tk - Tq``)."""
    qpos = torch.arange(tq, device=device)[:, None]
    kpos = torch.arange(tk, device=device)[None, :]
    return qpos + (tk - tq) >= kpos


def flash_attention_fwd_plain(q, k, v, causal, scale):
    """Plain PyTorch version: the same function as the kernel, in f32.

    Mirrors ``paddle_tpu``'s ``_plain_attention`` and adds the kernel's
    lse output and its fully-masked-row rule (l == 0 clamped to 1)."""
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = None
    if causal:
        mask = _causal_mask(tq, tk, q.device)
        s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    out = torch.matmul(p, v.float()) / l
    lse = (m + torch.log(l)).reshape(b * h, tq)
    return out.to(q.dtype), lse


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd: q/k/v must be [B, H, T, D]")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or \
            k.shape[3] != q.shape[3]:
        raise ValueError(
            f"flash_attention_fwd: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if q.shape[3] < 1:
        raise ValueError("flash_attention_fwd: head dim 0")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError("flash_attention_fwd: q/k/v must all be float32 "
                        f"or all bfloat16, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: q/k/v on different devices")


def _aligned(x):
    """Whether every row of ``x`` is contiguous and starts on 16 bytes, as
    the kernels' 16-byte copies need: a unit-stride head dim, the base
    pointer and each B, H and T stride (of a dim longer than 1)."""
    return x.stride(3) == 1 and x.data_ptr() % 16 == 0 and all(
        n == 1 or st * x.element_size() % 16 == 0
        for n, st in zip(x.shape[:3], x.stride()[:3]))


def _launch(q, k, v, causal, scale):
    _check(q, k, v)
    d_in = q.shape[3]
    q, k, v = (_aligned_copy(_pad_head(x, flash_attention_fwd),
                             flash_attention_fwd) for x in (q, k, v))
    b, h, tq, d = q.shape
    tk = k.shape[2]
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _load(_KERNEL, {"pt_flash_attention_fwd": 5}, 9)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            _DTYPE_CODES[q.dtype], int(bool(causal)), float(scale), stream)
    if err != 0:
        raise RuntimeError("flash_attention_fwd kernel launch failed: "
                           + lib.pt_cuda_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return _unpad_head(out, d_in), lse


def _pad_head(x, counted_in):
    """``x`` [B,H,T,D], or a copy zero-padded along D to the next multiple
    of 16 (the head dims the kernels take), counted in
    ``counted_in.copies``."""
    d = x.shape[3]
    padded = -(-d // _HEAD_DIM_STEP) * _HEAD_DIM_STEP
    if padded == d:
        return x
    counted_in.copies += 1
    return torch.nn.functional.pad(x, (0, padded - d))


def _unpad_head(x, d):
    """The first ``d`` columns of a kernel's padded output, contiguous."""
    return x if x.shape[3] == d else x[..., :d].contiguous()


def _aligned_copy(x, counted_in):
    """``x``, or a contiguous copy of it when a row is not contiguous or
    not 16-byte aligned; each copy is counted in ``counted_in.copies``."""
    if _aligned(x):
        return x
    counted_in.copies += 1
    return x.clone(memory_format=torch.contiguous_format)


def _load(name, n_ptrs, n_strides):
    """Builds (at first use) and loads kernel library ``name``; declares
    each ``fn`` of ``n_ptrs`` ({fn: tensor pointers}) as taking those
    pointers, B, H, Tq, Tk, D, ``n_strides`` int64 strides, the dtype
    code, the causal flag, the scale and the stream."""
    from paddle_tpu_torch import _build

    lib = _build.load(name)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    for fn_name, n in n_ptrs.items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = ([ptr] * n + [ctypes.c_int] * 5 + [i64] * n_strides
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ptr])
            fn.restype = ctypes.c_int
    if lib.pt_cuda_error_string.argtypes is None:
        lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """q [B,H,Tq,D], k/v [B,H,Tk,D] -> (out [B,H,Tq,D], lse [B*H,Tq]).

    ``scale`` None means ``1/sqrt(D)``.  CUDA tensors run the kernel;
    CPU and meta tensors run the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    raise ValueError(f"flash_attention_fwd: no implementation for device "
                     f"{q.device}")


flash_attention_fwd.launches = 0
flash_attention_fwd.copies = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _delta(o, do, dlse):
    """rowsum(dO*O) - dlse as [B*H, Tq] f32."""
    b, h, tq, _ = o.shape
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, tq)
    if dlse is not None:
        delta = delta - dlse.float().reshape(b * h, tq)
    return delta


def _bwd_block(q, k, v, do, lse, delta, rows, keys, causal, scale):
    """P and dS (f32) of the q rows ``rows`` against the keys ``keys``
    (``(start, stop)`` pairs), with the kernels' masks and rounding:
    dS rounded to the input dtype, P left in f32.  ``lse`` and
    ``delta`` are [B, H, Tq]."""
    (r0, r1), (c0, c1) = rows, keys
    tq, tk = q.shape[2], k.shape[2]
    s = torch.matmul(q[:, :, r0:r1].float(),
                     k[:, :, c0:c1].float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[:, :, r0:r1, None])
    if causal:
        # also zeroes fully masked rows, whose lse is -1e30
        qpos = torch.arange(r0, r1, device=q.device)[:, None] + (tk - tq)
        p = torch.where(qpos >= torch.arange(c0, c1, device=q.device),
                        p, 0.0)
    dp = torch.matmul(do[:, :, r0:r1].float(),
                      v[:, :, c0:c1].float().transpose(-1, -2))
    ds = (p * (dp - delta[:, :, r0:r1, None]) * scale).to(q.dtype).float()
    return p, ds


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale,
                              dlse=None, rows=None, keys=None, chunk=None):
    """Plain PyTorch version of the backward kernels: P recomputed from
    lse (not autograd of the plain forward), the kernels' masks and
    rounding.  Returns (dq, dk, dv) in the input dtype.

    Sliced: ``rows`` (a ``(start, stop)`` pair) limits dq to those q
    rows and ``keys`` dk/dv to those keys; the sums over the other axis
    then run ``chunk`` keys (for dq) or q rows (for dk/dv) at a time,
    skipping chunks the causal band hides, so a 32768-token backward
    is checked without its 32768^2 score matrices."""
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    lse = lse.reshape(b, h, tq)
    delta = _delta(o, do, dlse).reshape(b, h, tq)
    if rows is None and keys is None and chunk is None:
        p, ds = _bwd_block(q, k, v, do, lse, delta, (0, tq), (0, tk),
                           causal, scale)
        dq = torch.matmul(ds, k.float())
        dk = torch.matmul(ds.transpose(-1, -2), q.float())
        dv = torch.matmul(p.transpose(-1, -2), do.float())
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    rows = rows or (0, tq)
    keys = keys or (0, tk)
    step = chunk or max(tq, tk)
    q_off = tk - tq if causal else 0
    dq = torch.zeros((b, h, rows[1] - rows[0], q.shape[3]),
                     dtype=torch.float32, device=q.device)
    for c0 in range(0, tk, step):
        c1 = min(c0 + step, tk)
        if causal and rows[1] - 1 + q_off < c0:
            break                      # no row sees these keys
        _, ds = _bwd_block(q, k, v, do, lse, delta, rows, (c0, c1),
                           causal, scale)
        dq += torch.matmul(ds, k[:, :, c0:c1].float())
    dk = torch.zeros((b, h, keys[1] - keys[0], k.shape[3]),
                     dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, tq, step):
        r1 = min(r0 + step, tq)
        if causal and r1 - 1 + q_off < keys[0]:
            continue                   # these rows see none of the keys
        p, ds = _bwd_block(q, k, v, do, lse, delta, (r0, r1), keys,
                           causal, scale)
        dk += torch.matmul(ds.transpose(-1, -2), q[:, :, r0:r1].float())
        dv += torch.matmul(p.transpose(-1, -2), do[:, :, r0:r1].float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_prepare(q, k, v, o, lse, do, dlse):
    """Checks the backward's inputs; returns (q, k, v, dO, lse, delta) as
    the kernels take them: D padded to a multiple of 16 and rows
    contiguous and 16-byte aligned (a copy where not, counted in
    ``flash_attention_bwd.copies``), dO in q's dtype."""
    _check(q, k, v)
    b, h, tq, _ = q.shape
    if do.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and "
                         f"dO {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if lse.shape != (b * h, tq) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: lse must be [B*H, Tq] f32")
    if do.dtype != q.dtype:
        do = do.to(q.dtype)
    delta = _delta(o, do, dlse).contiguous()
    q, k, v, do = (_aligned_copy(_pad_head(x, flash_attention_bwd),
                                 flash_attention_bwd) for x in (q, k, v, do))
    return q, k, v, do, lse.contiguous(), delta


def _bwd_kernel(name, q, k, v, do, lse, delta, outs, causal, scale):
    """Launches one backward kernel, ``dq`` (outs = (dq,)) or ``dkv``
    (outs = (dk, dv)), on prepared inputs and contiguous outputs."""
    b, h, tq, d = q.shape
    # q, k, v, dO, lse, delta and 1 (dq) or 2 (dk, dv) outputs; q/k/v/dO
    # strides
    lib = _load(_BWD_KERNEL, {"pt_flash_attention_bwd_dq": 7,
                              "pt_flash_attention_bwd_dkv": 8}, 12)
    strides = (q.stride(0), q.stride(1), q.stride(2),
               k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2),
               do.stride(0), do.stride(1), do.stride(2))
    fn = getattr(lib, f"pt_flash_attention_bwd_{name}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs), b, h, tq, k.shape[2], d,
                 *strides, _DTYPE_CODES[q.dtype], int(bool(causal)),
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd {name} kernel launch "
                           "failed: "
                           + lib.pt_cuda_error_string(err).decode())
    flash_attention_bwd.launches[name] += 1


def _bwd_launch(q, k, v, o, lse, do, causal, scale, dlse):
    d_in = q.shape[3]
    q, k, v, do, lse, delta = _bwd_prepare(q, k, v, o, lse, do, dlse)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return tuple(_unpad_head(g.zero_(), d_in) for g in (dq, dk, dv))
    _bwd_kernel("dq", q, k, v, do, lse, delta, (dq,), causal, scale)
    _bwd_kernel("dkv", q, k, v, do, lse, delta, (dk, dv), causal, scale)
    return tuple(_unpad_head(g, d_in) for g in (dq, dk, dv))


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None,
                        dlse=None):
    """Gradients (dq, dk, dv) of flash attention from the forward's
    ``o`` and ``lse`` and the output cotangent ``do``; ``dlse`` is the
    optional cotangent of ``lse``.  CUDA tensors run the dq and dkv
    kernels; CPU and meta tensors run the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _bwd_launch(q, k, v, o, lse, do, causal, scale, dlse)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         scale, dlse)
    raise ValueError(f"flash_attention_bwd: no implementation for device "
                     f"{q.device}")


flash_attention_bwd.launches = {"dq": 0, "dkv": 0}
flash_attention_bwd.copies = 0


class FlashAttention(torch.autograd.Function):
    """(out, lse) = flash attention of (q, k, v), differentiable in both
    outputs: the forward kernel, and the two backward kernels with the
    cotangent of lse folded into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         ctx.causal, ctx.scale, dlse)
        return dq, dk, dv, None, None


def flash_attention_lse(q, k, v, causal=False, scale=None):
    """(out [B,H,Tq,D], lse [B*H,Tq]), differentiable in q, k and v
    through both outputs: the mergeable summary that ring attention
    combines across chunks (counterpart of ``pallas_kernels.py:697``;
    the port's lse is not padded to a tile)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, bool(causal), float(scale))


@register_op("flash_attention", inputs=("Q", "K", "V"), outputs=("Out",),
             attrs={"causal": False, "scale": 0.0, "block_q": 0,
                    "block_k": 0, "gspmd_batch_axis": "",
                    "gspmd_head_axis": ""})
def _flash_attention_op(ins, attrs, device):
    """The IR op.  ``scale`` 0.0 means 1/sqrt(D).  The tile sizes and the
    gspmd axes are the JAX package's and change nothing on one card.
    With tracing on, the entry is a device-trace annotation site."""
    if _obs_trace._tracer is not None:
        with _obs_device.annotate("flash_attention"):
            return _flash_attention_entry(ins, attrs)
    return _flash_attention_entry(ins, attrs)


def _flash_attention_entry(ins, attrs):
    out, _ = flash_attention_lse(ins["Q"], ins["K"], ins["V"],
                                 causal=bool(attrs["causal"]),
                                 scale=attrs["scale"] or None)
    return {"Out": out}
