"""Paged flash-decode attention: the CUDA kernel, its plain version, the op.

Counterpart of the decode half of ``paddle_tpu/ops/pallas_kernels.py``
(``:782-1279``, op ``:1349-1363``).  One query token per sequence (q
``[B, H, d]``) or the R newest tokens of each sequence as separate
query rows (q ``[B, R, H, d]``, the speculative verify sweep) attend
over that sequence's cached prefix, streamed page by page from the
``ops/paged_kv.py`` pools ``[P+1, H, page_size, d]`` through the block
tables ``[B, MP]`` int32; ``seq_lens [B]`` int32 is the full cached
length, the R window tokens included.  Row r sees keys ``< min(len,
len - R + 1 + r)``.  The output has q's shape.

int8 pools need ``kv_scales = (k_scale, v_scale)``, per channel ``[H,
d]``.  Their dequantization stays outside the kernel, as in the JAX
package (``_int8_pre``/``_int8_post``, ``:1063-1083``): the K scale
pre-multiplies q (the kernel then takes f32 q over int8 pages and
writes f32), and the V scale multiplies the output, which is then cast
to q's dtype.

The kernel replaces ``_decode_kernel`` (wrapper ``_flash_decode_pallas``):
``csrc/flash_decode.cu``, whose header says how it is laid out and what
bounds it.  The TPU kernel's sublane-replicated query rows, head
packing, scalar-prefetch grid and VMEM budget with its quiet fall-back
to the reference are Mosaic rules and are gone: every page size, every
head dim and any number of query rows run the kernel (one CTA serves up
to 16 rows of a sequence and head; a long sequence is cut into splits of
16 pages, merged in split order through a workspace this wrapper
allocates; above d 2048 a second kernel takes the output in slices of
2048 columns).  The JAX package's ``head_pack`` has no
counterpart: the kernel has nothing to pack.

``flash_decode`` dispatches on the device of ``q``: a CUDA tensor
launches the kernel (a build or launch failure raises), a CPU or meta
tensor takes ``flash_decode_plain``.  ``impl="xla"`` or
``"interpret"`` asks for the plain version on any device (tests
only).  Launches are counted in ``flash_decode.launches``, under a lock: the
decode server launches from its replica worker threads.

``flash_decode_plain`` replays the page-ordered online softmax of
``_decode_reference_impl``/``_decode_reference_multi_impl``
(``:1086-1206``) with the same op order and rounding points: per page,
``s = (q.k)*scale`` in f32 masked to -1e30, ``m' = max(m, max s)``,
``p = exp(s - m')`` zeroed where masked, ``l = l*a + sum p`` and ``acc =
acc*a + p.V`` with ``a = exp(m - m')`` and p cast to V's dtype first
(f32 over int8 pages); ``l == 0`` becomes 1, and one cast at the end.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.observability import device_trace as _obs_device
from paddle_tpu_torch.observability import tracing as _obs_trace

_NEG_INF = -1e30
_KERNEL = "flash_decode"
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_LAUNCH_LOCK = threading.Lock()


def _int8_pre(q, kv_scales):
    """The K scale rides the contraction: sum_d q_d*(k_td*s_d) ==
    sum_d (q_d*s_d)*k_td, so q is scaled once instead of every page."""
    if kv_scales is None:
        raise ValueError("int8 k_pages/v_pages need kv_scales "
                         "(per-channel [H, d] — paged_kv.kv_scales())")
    kdq = kv_scales[0].float() / 127.0
    vdq = kv_scales[1].float() / 127.0
    kdq = kdq[None] if q.dim() == 3 else kdq[None, None]
    return q.float() * kdq, vdq


def _int8_post(raw, vdq, out_dtype):
    """The V scale is per output channel: it applies to the result."""
    vdq = vdq[None] if raw.dim() == 3 else vdq[None, None]
    return (raw * vdq).to(out_dtype)


def _plain_raw(q, k_pages, v_pages, block_tables, seq_lens, scale):
    """The online-softmax replay over gathered pages, q [B, R, H, d]."""
    b, rr, _, d = q.shape
    ps = k_pages.shape[2]
    int8kv = k_pages.dtype == torch.int8
    dev = q.device
    tables = torch.as_tensor(block_tables).to(dev, torch.long)
    lens = torch.as_tensor(seq_lens).to(dev, torch.long)
    qf = q.permute(0, 2, 1, 3).float()                   # [B, H, R, d]
    m = torch.full(qf.shape[:3], _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(qf.shape[:3], dtype=torch.float32, device=dev)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=dev)
    row = torch.arange(rr, device=dev)
    limit = torch.minimum(lens[:, None], lens[:, None] - rr + 1 + row)
    kpos0 = torch.arange(ps, device=dev)
    for p in range(tables.shape[1]):
        k = k_pages[tables[:, p]]                         # [B, H, ps, d]
        v = v_pages[tables[:, p]]
        mask = (p * ps + kpos0)[None, None, None, :] < \
            limit[:, None, :, None]                       # [B, 1, R, ps]
        s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale
        s = torch.where(mask, s, _NEG_INF)
        m_next = torch.maximum(m, s.amax(dim=-1))
        p_ = torch.exp(s - m_next[..., None])
        p_ = torch.where(mask, p_, 0.0)
        alpha = torch.exp(m - m_next)
        l = l * alpha + p_.sum(dim=-1)
        pv = p_ if int8kv else p_.to(v.dtype).float()
        acc = acc * alpha[..., None] + torch.matmul(pv, v.float())
        m = m_next
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3)


def _as_rows(q):
    return q.unsqueeze(1) if q.dim() == 3 else q


def flash_decode_plain(q, k_pages, v_pages, block_tables, seq_lens, *,
                       scale=None, kv_scales=None):
    """Plain PyTorch version of ``flash_decode``, on any device."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if k_pages.dtype == torch.int8:
        q_eff, vdq = _int8_pre(q, kv_scales)
        raw = _plain_raw(_as_rows(q_eff), k_pages, v_pages, block_tables,
                         seq_lens, float(scale))
        raw = raw[:, 0] if q.dim() == 3 else raw
        return _int8_post(raw, vdq, q.dtype)
    out = _plain_raw(_as_rows(q), k_pages, v_pages, block_tables,
                     seq_lens, float(scale))
    return out[:, 0] if q.dim() == 3 else out


def _check(q4, k_pages, v_pages, tables, lens):
    b, rr, h, d = q4.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or \
            k_pages.shape[1] != h or k_pages.shape[3] != d:
        raise ValueError(
            f"flash_decode: q {tuple(q4.shape)} and pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not agree "
            "(pools are [P, H, page_size, d])")
    if d < 1:
        raise ValueError(f"flash_decode: head dim {d} is not positive")
    kv = k_pages.dtype
    if kv not in _KV_CODES or v_pages.dtype != kv or \
            q4.dtype != (torch.float32 if kv == torch.int8 else kv):
        raise TypeError(f"flash_decode: q {q4.dtype} over pools "
                        f"{kv}/{v_pages.dtype}; the kernel takes f32 or "
                        "bf16 q over pools of its dtype, or f32 q over "
                        "int8 pools")
    if tables.dim() != 2 or tables.shape[0] != b or lens.shape != (b,):
        raise ValueError(f"flash_decode: block_tables {tuple(tables.shape)}"
                         f" and seq_lens {tuple(lens.shape)} must be "
                         f"[{b}, MP] and [{b}]")
    for t in (k_pages, v_pages):
        if t.device != q4.device or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError("flash_decode: the pools must be contiguous, "
                             "16-byte aligned and on q's device")


def _launch(q, k_pages, v_pages, block_tables, seq_lens, scale):
    q4 = _as_rows(q)
    if q4.stride(3) != 1:
        q4 = q4.contiguous()  # the kernel reads a row's d values in order
    tables = torch.as_tensor(block_tables).to(q.device, torch.int32)
    lens = torch.as_tensor(seq_lens).to(q.device, torch.int32)
    tables, lens = tables.contiguous(), lens.contiguous()
    _check(q4, k_pages, v_pages, tables, lens)
    b, rr, h, d = q4.shape
    out = torch.empty((b, rr, h, d), dtype=q4.dtype, device=q.device)
    if out.numel() == 0 or tables.shape[1] == 0:
        return out.zero_()[:, 0] if q.dim() == 3 else out.zero_()
    lib = _load()
    mp = tables.shape[1]
    # the splits' partials (acc, m, l of each row), merged by the kernel's
    # second pass; none when every sequence fits one split
    splits = lib.pt_flash_decode_splits(mp)
    ws = torch.empty(b * h * rr * splits * (d + 2), dtype=torch.float32,
                     device=q.device) if splits > 1 else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_decode(
            q4.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), b, rr, h, d,
            k_pages.shape[2], mp, q4.stride(0), q4.stride(1),
            q4.stride(2), _KV_CODES[k_pages.dtype], float(scale), stream)
    if err != 0:
        raise RuntimeError("flash_decode kernel launch failed: "
                           + lib.pt_cuda_error_string(err).decode())
    with _LAUNCH_LOCK:
        flash_decode.launches += 1
    return out[:, 0] if q.dim() == 3 else out


def _load():
    from paddle_tpu_torch import _build

    lib = _build.load(_KERNEL)
    if lib.pt_flash_decode.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pt_flash_decode.argtypes = (
            [ptr] * 7 + [i32] * 6 + [i64] * 3 + [i32, ctypes.c_float, ptr])
        lib.pt_flash_decode.restype = ctypes.c_int
        lib.pt_flash_decode_splits.argtypes = [ctypes.c_int]
        lib.pt_flash_decode_splits.restype = ctypes.c_int
        lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_decode(q, k_pages, v_pages, block_tables, seq_lens, *,
                 scale=None, impl=None, kv_scales=None):
    """Paged-KV decode attention (module docstring).  ``scale`` None
    means 1/sqrt(d).  With tracing on, the entry is a device-trace
    annotation site."""
    if _obs_trace._tracer is not None:
        with _obs_device.annotate("flash_decode"):
            return _flash_decode_entry(q, k_pages, v_pages, block_tables,
                                       seq_lens, scale, impl, kv_scales)
    return _flash_decode_entry(q, k_pages, v_pages, block_tables,
                               seq_lens, scale, impl, kv_scales)


def _flash_decode_entry(q, k_pages, v_pages, block_tables, seq_lens,
                        scale, impl, kv_scales):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl not in (None, "interpret", "xla"):
        raise ValueError(f"flash_decode: unknown impl {impl!r}")
    if impl in ("interpret", "xla") or (
            impl is None and q.device.type in ("cpu", "meta")):
        return flash_decode_plain(q, k_pages, v_pages, block_tables,
                                  seq_lens, scale=scale, kv_scales=kv_scales)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: the kernel needs a CUDA tensor, "
                         f"got one on {q.device}")
    if k_pages.dtype == torch.int8:
        q_eff, vdq = _int8_pre(q, kv_scales)
        raw = _launch(q_eff, k_pages, v_pages, block_tables, seq_lens,
                      scale)
        return _int8_post(raw, vdq, q.dtype)
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, scale)


flash_decode.launches = 0


@register_op("flash_decode",
             inputs=("Q", "KPages", "VPages", "BlockTables", "SeqLens",
                     "KScale", "VScale"),
             outputs=("Out",), optional=("KScale", "VScale"),
             attrs={"scale": 0.0})
def _flash_decode_op(ins, attrs, device):
    """The IR op; KScale/VScale are the int8 pools' per-channel dequant
    scales, ``scale`` 0.0 means 1/sqrt(d)."""
    kv_scales = None
    if "KScale" in ins:
        kv_scales = (ins["KScale"], ins["VScale"])
    return {"Out": flash_decode(ins["Q"], ins["KPages"], ins["VPages"],
                                ins["BlockTables"], ins["SeqLens"],
                                scale=attrs.get("scale") or None,
                                kv_scales=kv_scales)}
