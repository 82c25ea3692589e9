"""The port's paged KV-cache (paddle_tpu_torch/ops/paged_kv.py) against
the JAX package's (paddle_tpu/ops/paged_kv.py).

The same numpy K/V, made from a seed, go through the same call sequence
on both caches; the pools must then be array_equal (the port writes in
place, the JAX package functionally), and the block tables, lengths,
refcounts and stats equal.  The allocator's own contracts (accounting,
atomic out-of-pages, copy-on-write, fork, truncate, detach/adopt, the
int8 contract) are checked on the port as the JAX package's tests check
them there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_port_helpers import to_numpy

from paddle_tpu.ops import paged_kv as jkv
from paddle_tpu_torch.ops import paged_kv as tkv
from paddle_tpu_torch.ops.paged_kv import OutOfPagesError, PagedKVCache


def _cache(**kw):
    return PagedKVCache(device="cpu", **kw)


def _kv(rng, n, h=2, d=8):
    return (rng.randn(n, h, d).astype(np.float32),
            rng.randn(n, h, d).astype(np.float32))


def _toks(rng, n):
    return [int(t) for t in rng.randint(2, 100, size=n)]


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------

def test_alloc_append_free_accounting():
    c = _cache(num_pages=8, page_size=4, num_heads=2, head_dim=8)
    rng = np.random.RandomState(0)
    s0 = c.prefill(*_kv(rng, 3))                 # 1 page
    s1 = c.prefill(*_kv(rng, 6))                 # 2 pages
    assert c.in_use_pages() == 3 and c.free_pages() == 5
    assert c.seq_len(s0) == 3 and c.seq_len(s1) == 6
    c.append([s0], *_kv(rng, 1))
    assert c.in_use_pages() == 3                 # 3 -> 4 fits page 0
    c.append([s0], *_kv(rng, 1))
    assert c.in_use_pages() == 4                 # 4 -> 5 takes a page
    ok, detail = c.check_accounting()
    assert ok, detail
    c.free(s0)
    assert c.in_use_pages() == 2 and c.free_pages() == 6
    c.free(s1)
    assert c.in_use_pages() == 0 and c.free_pages() == 8
    st = c.stats()
    assert st["accounted"] and st["shared_pages"] == 0
    assert st["kv_share"] is False
    with pytest.raises(KeyError):
        c.free(s0)                               # double free is loud


def test_out_of_pages_is_typed_and_atomic():
    c = _cache(num_pages=2, page_size=4, num_heads=1, head_dim=8)
    rng = np.random.RandomState(0)
    with pytest.raises(OutOfPagesError):
        c.prefill(*_kv(rng, 12, h=1))            # 3 pages
    assert c.free_pages() == 2                   # nothing half-allocated
    s = c.prefill(*_kv(rng, 8, h=1))             # the full pool
    with pytest.raises(OutOfPagesError):
        c.append([s], *_kv(rng, 1, h=1))
    assert c.seq_len(s) == 8                     # untouched on failure
    ok, detail = c.check_accounting()
    assert ok, detail


def test_prefill_roundtrip_and_gather():
    c = _cache(num_pages=6, page_size=4, num_heads=2, head_dim=8)
    k, v = _kv(np.random.RandomState(1), 7)
    s = c.prefill(k, v)
    tab = c.tables_for([s]).numpy()
    got = c.k_pages.numpy()[tab[0]]              # [2 pages, H, ps, d]
    flat = got.transpose(0, 2, 1, 3).reshape(-1, 2, 8)[:7]
    assert np.array_equal(flat, k)


def test_scatter_puts_the_batch_axis_first():
    """pool[page_ids, :, offsets, :] = vals takes vals [N, H, d]: the
    two advanced indices split by a slice put N first, as in JAX."""
    c = _cache(num_pages=4, page_size=4, num_heads=3, head_dim=8)
    rng = np.random.RandomState(7)
    slots = [c.prefill(*_kv(rng, 2, h=3)) for _ in range(2)]
    k, v = _kv(rng, 2, h=3)
    c.append(slots, k, v)
    for i, s in enumerate(slots):
        page = c.tables_for([s]).numpy()[0, 0]
        assert np.array_equal(c.k_pages.numpy()[page, :, 2, :], k[i])
        assert np.array_equal(c.v_pages.numpy()[page, :, 2, :], v[i])


def test_padded_append_hits_sink_page():
    c = _cache(num_pages=4, page_size=4, num_heads=1, head_dim=8)
    rng = np.random.RandomState(2)
    s = c.prefill(*_kv(rng, 2, h=1))
    k = rng.randn(3, 1, 8).astype(np.float32)    # 1 real row, 2 padding
    c.append([s], k, k)
    assert c.seq_len(s) == 3
    ok, detail = c.check_accounting()
    assert ok, detail
    sink = c.k_pages.numpy()[c.sink_page, 0, 0]
    assert np.array_equal(sink, k[1, 0]) or np.array_equal(sink, k[2, 0])
    page = c.tables_for([s]).numpy()[0, 0]
    assert np.array_equal(c.k_pages.numpy()[page, 0, 2], k[0, 0])


def test_tables_lens_padding():
    c = _cache(num_pages=6, page_size=4, num_heads=1, head_dim=8)
    s = c.prefill(*_kv(np.random.RandomState(3), 5, h=1))
    t = c.tables_for([s], max_pages=4, pad_to=3)
    ln = c.lens_for([s], pad_to=3)
    assert t.shape == (3, 4) and ln.shape == (3,)
    assert t.dtype == ln.dtype == torch.int32
    assert ln.tolist() == [5, 0, 0]
    assert t[1:].eq(0).all() and t[0, 2:].eq(0).all()


def test_int8_storage_rides_quant_contract():
    c = _cache(num_pages=4, page_size=4, num_heads=2, head_dim=8,
               kv_int8=True)
    k, v = _kv(np.random.RandomState(4), 4)
    s = c.prefill(k, v)
    ks, vs = c.kv_scales()
    assert ks.shape == (2, 8)
    stored = c.k_pages[c.tables_for([s])[0, 0]]  # [H, ps, d] int8
    assert stored.dtype == torch.int8
    deq = tkv.dequantize_kv(stored.transpose(0, 1), ks).numpy()[:4]
    assert np.allclose(deq, k, atol=float(np.abs(k).max()) / 100.0)
    # the JAX package's contract, bit for bit: q = clip(round(x/s*127))
    jks = jkv.kv_scales_of(jnp.asarray(k))
    assert np.array_equal(np.asarray(jks), ks.numpy())
    assert np.array_equal(np.asarray(jkv.quantize_kv(jnp.asarray(k), jks)),
                          stored.transpose(0, 1).numpy()[:4])
    assert np.array_equal(
        np.asarray(jkv.dequantize_kv(jkv.quantize_kv(jnp.asarray(k), jks),
                                     jks)),
        tkv.dequantize_kv(tkv.quantize_kv(torch.from_numpy(k), ks),
                          ks).numpy())


def test_shared_prefill_refcounts_and_amortization():
    rng = np.random.RandomState(0)
    c = _cache(num_pages=16, page_size=4, num_heads=2, head_dim=8,
               kv_share=True)
    prefix = _toks(rng, 8)                       # 2 full pages
    s0 = c.prefill(*_kv(rng, 11), tokens=prefix + _toks(rng, 3))
    assert c.in_use_pages() == 3 and c.shared_pages() == 0
    assert c.shared_prefix_tokens(prefix + _toks(rng, 5)) == 8
    s1 = c.prefill(*_kv(rng, 5), tokens=prefix + _toks(rng, 5))
    assert c.shared_pages() == 2
    assert c.in_use_pages() == 5                 # 2 tail pages only
    c.free(s0)
    assert c.shared_pages() == 0 and c.in_use_pages() == 4
    c.free(s1)
    assert c.in_use_pages() == 0 and c.free_pages() == 16
    ok, detail = c.check_accounting()
    assert ok, detail


def test_fork_cow_append_and_mid_fork_kill():
    rng = np.random.RandomState(2)
    c = _cache(num_pages=16, page_size=4, num_heads=2, head_dim=8,
               kv_share=True)
    parent = c.prefill(*_kv(rng, 6))             # 1.5 pages
    child = c.fork(parent)
    assert c.seq_len(child) == 6
    assert c.in_use_pages() == 2 and c.shared_pages() == 2
    ka, va = _kv(rng, 1)
    kb, vb = _kv(rng, 1)
    c.append([parent], ka, va)                   # the partial page copies
    assert c.shared_pages() == 1
    c.append([child], kb, vb)
    tp = c.tables_for([parent]).numpy()[0]
    tc = c.tables_for([child]).numpy()[0]
    assert tp[0] == tc[0] and tp[1] != tc[1]
    kp = c.k_pages.numpy()
    assert np.array_equal(kp[tp[1], :, :2], kp[tc[1], :, :2])
    assert np.array_equal(kp[tp[1], 0, 2], ka[0, 0])
    assert np.array_equal(kp[tc[1], 0, 2], kb[0, 0])
    c.free(parent)                               # the child's pages live
    assert c.seq_len(child) == 7
    c.free(child)
    assert c.in_use_pages() == 0
    ok, detail = c.check_accounting()
    assert ok, detail


def test_fork_needs_kv_share():
    c = _cache(num_pages=4, page_size=4, num_heads=1, head_dim=8)
    s = c.prefill(*_kv(np.random.RandomState(0), 2, h=1))
    with pytest.raises(RuntimeError):
        c.fork(s)


def test_truncate_rewinds_pages_atomically():
    rng = np.random.RandomState(3)
    c = _cache(num_pages=16, page_size=4, num_heads=2, head_dim=8)
    s = c.prefill(*_kv(rng, 14))                 # 4 pages
    c.truncate(s, 5)                             # back to 2 pages
    assert c.seq_len(s) == 5 and c.in_use_pages() == 2
    with pytest.raises(ValueError):
        c.truncate(s, 6)                         # can't grow
    c.extend(s, *_kv(rng, 9))
    assert c.seq_len(s) == 14
    ok, detail = c.check_accounting()
    assert ok, detail


def test_extend_matches_whole_prefill_bytes():
    k, v = _kv(np.random.RandomState(4), 13)
    c1 = _cache(num_pages=8, page_size=4, num_heads=2, head_dim=8)
    s1 = c1.prefill(k, v)
    c2 = _cache(num_pages=8, page_size=4, num_heads=2, head_dim=8)
    s2 = c2.prefill(k[:3], v[:3])
    for lo, hi in ((3, 8), (8, 13)):
        c2.extend(s2, k[lo:hi], v[lo:hi])
    t1, t2 = c1.tables_for([s1])[0], c2.tables_for([s2])[0]
    assert torch.equal(c1.k_pages[t1.long()], c2.k_pages[t2.long()])
    assert torch.equal(c1.v_pages[t1.long()], c2.v_pages[t2.long()])


def test_out_of_pages_atomic_under_cow_and_extend():
    rng = np.random.RandomState(5)
    c = _cache(num_pages=3, page_size=4, num_heads=1, head_dim=8,
               kv_share=True)
    s = c.prefill(*_kv(rng, 6, h=1))             # 2 pages
    child = c.fork(s)
    c.append([s], *_kv(rng, 1, h=1))             # the copy takes the free
    assert c.free_pages() == 0
    c.fork(child)
    with pytest.raises(OutOfPagesError):
        c.append([child], *_kv(rng, 1, h=1))
    assert c.free_pages() == 0 and c.seq_len(child) == 6
    ok, detail = c.check_accounting()
    assert ok, detail


def test_detach_adopt_release_move_no_bytes():
    rng = np.random.RandomState(6)
    c = _cache(num_pages=8, page_size=4, num_heads=2, head_dim=8)
    s = c.prefill(*_kv(rng, 6))
    before = c.k_pages.clone()
    handle = c.detach(s)
    assert c.in_transit_pages() == 2 and c.free_pages() == 6
    s2 = c.adopt(handle)
    assert c.seq_len(s2) == 6 and c.in_transit_pages() == 0
    assert torch.equal(before, c.k_pages)
    with pytest.raises(KeyError):
        c.adopt(handle)                          # settled
    h2 = c.detach(s2)
    assert c.release_in_transit(h2) == 2
    assert c.in_use_pages() == 0
    ok, detail = c.check_accounting()
    assert ok, detail


def test_page_pool_gauges_exported(monkeypatch):
    from paddle_tpu_torch.observability import metrics as obs_metrics
    from paddle_tpu_torch.ops import paged_kv as pkv

    # each gauge keeps at most 64 caches' series, for the process's
    # life: start from none, whatever caches the worker made before
    for gauge in (pkv._G_FREE, pkv._G_IN_USE, pkv._G_SHARED, pkv._G_FRAG,
                  pkv._G_TRANSIT):
        monkeypatch.setattr(gauge, "_series", {})
    c = _cache(num_pages=8, page_size=4, num_heads=1, head_dim=8)
    c.prefill(*_kv(np.random.RandomState(6), 5, h=1))
    snap = obs_metrics.registry().snapshot()
    for g in ("paddle_tpu_paged_kv_pages_free",
              "paddle_tpu_paged_kv_pages_in_use",
              "paddle_tpu_paged_kv_pages_shared",
              "paddle_tpu_paged_kv_internal_frag_pct"):
        assert g in snap, g
    series = {s["labels"].get("cache"): s["value"]
              for s in snap["paddle_tpu_paged_kv_pages_in_use"]["series"]}
    assert series[c._label] == 2.0


def test_cache_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cache runs there")
    from paddle_tpu_torch.core.types import NoCUDADeviceError

    with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
        PagedKVCache(num_pages=2, page_size=4, num_heads=1, head_dim=8)


# ---------------------------------------------------------------------------
# the port's pools equal the JAX package's after the same calls
# ---------------------------------------------------------------------------

def _script(seed, n_ops, share):
    """A seeded call sequence: prefills (shared prompts under kv_share),
    batched appends (with padding rows), extends, truncates, forks and
    frees.  Each entry carries its numpy data."""
    rng = np.random.RandomState(seed)
    prefixes = [_toks(rng, 8), _toks(rng, 12)]
    ops = []
    for _ in range(n_ops):
        op = rng.randint(6)
        if op == 0:
            toks = prefixes[rng.randint(2)] + _toks(rng,
                                                    int(rng.randint(1, 6)))
            ops.append(("prefill", _kv(rng, len(toks)),
                        toks if share else None))
        elif op == 1:
            ops.append(("append", int(rng.randint(1, 4)),
                        _kv(rng, 4), None))
        elif op == 2:
            ops.append(("extend", _kv(rng, int(rng.randint(1, 7))), None))
        elif op == 3:
            ops.append(("truncate", float(rng.rand()), None))
        elif op == 4 and share:
            ops.append(("fork", None, None))
        else:
            ops.append(("free", None, None))
    return ops


def _run(cache, ops, wrap):
    """Apply ``ops`` to ``cache``; ``wrap`` turns numpy into the
    package's arrays.  Returns the trail of (op, slots, lens) states."""
    rng = np.random.RandomState(99)
    live, trail = [], []
    for op in ops:
        kind = op[0]
        try:
            if kind == "prefill" or not live:
                if kind != "prefill":
                    continue
                (k, v), toks = op[1], op[2]
                live.append(cache.prefill(wrap(k), wrap(v), tokens=toks))
            elif kind == "append":
                n = min(op[1], len(live))
                k, v = op[2]
                cache.append(live[:n], wrap(k[:n + 1]), wrap(v[:n + 1]))
            elif kind == "extend":
                k, v = op[1]
                cache.extend(live[-1], wrap(k), wrap(v))
            elif kind == "truncate":
                s = live[0]
                cache.truncate(s, int(op[1] * cache.seq_len(s)))
            elif kind == "fork":
                live.append(cache.fork(live[rng.randint(len(live))]))
            else:
                cache.free(live.pop(rng.randint(len(live))))
        except OutOfPagesError if isinstance(cache, PagedKVCache) \
                else jkv.OutOfPagesError:
            cache.free(live.pop(0))
        trail.append((kind, list(live), [cache.seq_len(s) for s in live]))
    return trail, live


@pytest.mark.parametrize("share,int8,dtype", [
    (False, False, "float32"), (True, False, "float32"),
    (True, True, "float32"), (False, False, "bfloat16")])
def test_pools_equal_jax_after_the_same_calls(share, int8, dtype):
    ops = _script(11 + share + 2 * int8, 80, share)
    kw = dict(num_pages=20, page_size=4, num_heads=2, head_dim=8,
              kv_int8=int8, kv_share=share, max_seqs=8)
    tc = _cache(dtype=getattr(torch, dtype), **kw)
    jc = jkv.PagedKVCache(dtype=getattr(jnp, dtype), **kw)
    t_trail, t_live = _run(tc, ops, lambda x: x)
    j_trail, j_live = _run(jc, ops, jnp.asarray)
    assert t_trail == j_trail
    assert len(t_trail) > 40
    for name in ("k_pages", "v_pages"):
        assert np.array_equal(to_numpy(getattr(tc, name)),
                              to_numpy(getattr(jc, name))), name
    assert np.array_equal(tc._tables, jc._tables)
    assert np.array_equal(tc._ref, jc._ref)
    assert tc.stats() == jc.stats()
    if t_live:
        assert np.array_equal(tc.tables_for(t_live, pad_to=8).numpy(),
                              np.asarray(jc.tables_for(j_live, pad_to=8)))
        assert np.array_equal(tc.lens_for(t_live, pad_to=8).numpy(),
                              np.asarray(jc.lens_for(j_live, pad_to=8)))
    if int8:
        for a, b in zip(tc.kv_scales(), jc.kv_scales()):
            assert np.array_equal(a.numpy(), np.asarray(b))
    ok, detail = tc.check_accounting()
    assert ok, detail
