"""Continuous decode batching: the LLM-serving request type.

Counterpart of ``paddle_tpu/serving/decode_engine.py``.
Iteration-level (Orca-style) scheduling over N decode replicas: each
replica owns a model adapter and ONE paged KV-cache
(``ops/paged_kv.PagedKVCache``) and runs a supervised iteration loop.
Every iteration, new sequences join the running batch (prompt KV
prefilled into fresh pages), ONE decode step runs for the whole batch
(``ops/flash_decode.flash_decode`` over the shared page pool), and
finished sequences retire (pages freed, Request future answered).

The request path is the serving tier's:

  - admission: ``AdmissionController``, a bounded queue with typed
    shedding; every admitted sequence is answered exactly once;
  - deadlines: shed at submit, before joining the batch, and checked
    every iteration mid-generation;
  - drain: stop admitting, let running sequences finish, answer the
    leftovers with ShutdownError; afterwards every replica cache has
    ``in_use == 0``, zero page leaks;
  - failover: a replica killed mid-step (faultinject msg type
    ``serving_decode``) pushes its live sequences, full token history,
    onto an unbounded retry lane; a survivor re-prefills them.  The dead
    replica's cache is reset;
  - pool pressure: a batch that cannot take one more page PREEMPTS a
    sequence back to the retry lane (tokens so far preserved).  Scanning
    youngest to oldest, the first sequence whose deadline can afford a
    re-prefill is evicted; when every candidate is at risk the youngest
    goes.

Three options, each off by default (``DecodeConfig`` knob or flag):

  - CHUNKED PREFILL (``prefill_chunk``): a prompt longer than the chunk
    joins one fixed-size chunk of projections and page writes per
    iteration, interleaved with the running batch's decode steps.
  - PREFIX SHARING (``kv_share``): prompt prefill consults the cache's
    radix tree first; the longest already-cached full-page prefix is
    shared (refcounted, no projections, no writes).
  - LOSSLESS SPECULATIVE DECODING (``spec_k``): a small draft model (its
    own paged cache per replica) proposes k tokens, ONE batched
    q-len-(k+1) flash_decode verify step scores them,
    ``decode.spec_accept_length`` takes the longest agreeing prefix, and
    rejection is a page-pointer rewind (``PagedKVCache.truncate``).

Disaggregated prefill/decode tiers (``disagg_prefill``): the server
splits into a PREFILL pool of ``n_prefill_replicas`` workers (prompt
projections and page writes) and the decode pool behind the same
admission, every decode replica reading ONE shared page pool.  A
finished prefill reaches the decode tier as a page-list handoff
(``PagedKVCache.detach``/``adopt``: block-table entries and refcounts,
no K/V bytes moved), with the typed ``HandoffError`` when its attempt
budget is spent, the deadline carried across the tier boundary (expiry
in transit releases the pages and answers typed), and exactly-once
answers when a replica on either side dies mid-handoff: a prefill kill
after allocation releases the handoff and a survivor re-prefills; a
decode kill after adoption frees only its slots on the shared pool
(never a wholesale reset) and the prefill tier re-prefills from token
history.  The fault point ``serving_prefill`` sits between the detach
and the offer.  Ordering on the card: every tier's thread issues its
work on the device's default stream, the one stream they share, so a
prefill's page writes are queued before the adopting replica's
``flash_decode`` reads them (the handoff queue orders the two on the
host), and a freed page's last read is queued before any later write
into it.  No tier has a stream of its own, so no event rides a handoff.

``DecodeConfig(metrics_port=...)`` (or ``PADDLE_TPU_METRICS_PORT``)
mounts the ``/metrics`` exporter (``observability/export.py``) from
``start()`` to ``stop()``, and ``collector`` (or ``PADDLE_TPU_COLLECTOR``)
runs a fleet ``CollectorPusher`` (``observability/collector.py``) over
the same span.

Model adapter protocol (duck-typed; ``TinyDecodeLM`` is the built-in):

    model.vocab / num_heads / head_dim      (ints)
    model.qkv(tokens [N] int32) -> (q, k, v) each [N, H, d]
    model.logits(attn_out [N, H, d]) -> [N, vocab]

The engine is greedy (argmax) per step; eos or max_new_tokens retires a
sequence.  ``DecodeConfig(device=...)`` defaults to ``"cuda"`` and
raises without a card unless given ``"cpu"``.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.concurrency import BoundedQueue, Supervisor
from paddle_tpu_torch.distributed import faultinject
from paddle_tpu_torch.observability import flight_recorder as _flight
from paddle_tpu_torch.observability import metrics as _obs_metrics
from paddle_tpu_torch.observability import tracing as _trace
from paddle_tpu_torch.observability.collector import (CollectorPusher,
                                                      collector_endpoint)
from paddle_tpu_torch.observability.export import (MetricsHTTPServer,
                                                   metrics_port_from_env)
from paddle_tpu_torch.ops.epilogue import greedy_logits_tail
from paddle_tpu_torch.ops.flash_decode import flash_decode
from paddle_tpu_torch.ops.paged_kv import (OutOfPagesError, PagedKVCache,
                                           resolve_device)
from paddle_tpu_torch.serving.admission import (AdmissionController,
                                                DeadlineExpiredError,
                                                HandoffError,
                                                ReplicaFailedError,
                                                ShutdownError)
from paddle_tpu_torch.serving.replica_pool import ReplicaKilled

__all__ = ["MSG_DECODE", "MSG_PREFILL", "TinyDecodeLM", "DecodeConfig",
           "DecodeServer"]

MSG_DECODE = faultinject.register_msg_type("serving_decode")
# the disaggregated prefill tier: one decision per prefill, consulted
# after its pages are allocated and detached into the handoff
MSG_PREFILL = faultinject.register_msg_type("serving_prefill")

_M_DECODE = _obs_metrics.counter(
    "paddle_tpu_decode_events_total",
    "decode-server transitions (iterations / tokens_out / prefills / "
    "prefill_chunks / kills / step_faults / failovers / preemptions / "
    "retires / spec_proposed / spec_accepted), by event")
_M_STEP_MS = _obs_metrics.histogram(
    "paddle_tpu_decode_inter_token_seconds",
    "per-sequence inter-token latency")
_M_PAGE_UTIL = _obs_metrics.gauge(
    "paddle_tpu_decode_page_utilization",
    "in_use / num_pages of each replica's page pool, by replica "
    "index", max_series=64)
_M_ACTIVE = _obs_metrics.gauge(
    "paddle_tpu_decode_active_seqs",
    "sequences in the running batch, by replica index",
    max_series=64)
# the disaggregated tiers: handoff outcomes and latency (the p99 bucket's
# exemplar names a sampled trace), live replicas by tier, shared-pool pages
_M_HANDOFFS = _obs_metrics.counter(
    "paddle_tpu_disagg_handoffs_total",
    "prefill->decode page-list handoffs by outcome (offered / "
    "adopted / lost / expired / orphaned / killed)")
_M_HANDOFF_SECONDS = _obs_metrics.histogram(
    "paddle_tpu_disagg_handoff_seconds",
    "prefill-complete -> decode-adoption latency of page-list "
    "handoffs")
_G_TIER_REPLICAS = _obs_metrics.gauge(
    "paddle_tpu_disagg_tier_replicas",
    "live replicas per disaggregated tier (prefill / decode)",
    max_series=8)
_G_TIER_PAGES = _obs_metrics.gauge(
    "paddle_tpu_disagg_pages",
    "shared-pool page occupancy of the disaggregated server "
    "(in_use / in_transit / free)", max_series=8)

class TinyDecodeLM(nn.Module):
    """Deterministic seeded single-layer attention LM, the built-in model
    adapter.  Positionless on purpose: logits depend on the full cached
    prefix through attention only, so correct paged attention (and only
    that) reproduces the dense decode exactly.  The weights are drawn by
    ``numpy.random.RandomState(seed)`` in the JAX package's order, so the
    same seed gives the same weights in both packages."""

    def __init__(self, vocab=128, d_model=64, num_heads=4, head_dim=16,
                 seed=0, dtype=None, device="cuda"):
        super().__init__()
        self.vocab = int(vocab)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.device = resolve_device(device)
        dtype = dtype or torch.float32
        rng = np.random.RandomState(seed)
        hd = self.num_heads * self.head_dim

        def w(*shape):
            return nn.Parameter(torch.from_numpy(
                (rng.randn(*shape) * 0.3).astype(np.float32)).to(
                    self.device, dtype), requires_grad=False)

        self.embed = w(self.vocab, d_model)
        self.wq = w(d_model, hd)
        self.wk = w(d_model, hd)
        self.wv = w(d_model, hd)
        self.wo = w(hd, self.vocab)

    def qkv_fn(self, tokens):
        """tokens [N] (an index tensor on the model's device) -> q, k, v
        [N, H, d]."""
        e = self.embed[tokens]
        shp = (tokens.shape[0], self.num_heads, self.head_dim)
        return ((e @ self.wq).reshape(shp), (e @ self.wk).reshape(shp),
                (e @ self.wv).reshape(shp))

    def logits_fn(self, attn_out):
        """attn_out [N, H, d] -> logits [N, vocab]."""
        flat = attn_out.reshape(attn_out.shape[0],
                                self.num_heads * self.head_dim)
        return flat.to(self.wo.dtype) @ self.wo

    @torch.no_grad()
    def qkv(self, tokens):
        tokens = torch.as_tensor(np.asarray(tokens, np.int64),
                                 device=self.device)
        return self.qkv_fn(tokens)

    @torch.no_grad()
    def logits(self, attn_out):
        return self.logits_fn(attn_out)

    def forward(self, attn_out):
        return self.logits(attn_out)


class DecodeConfig:
    """Decode-server knobs, the JAX package's less ``impl`` (the kernel
    is chosen by the device) and ``head_pack`` (the kernel has nothing to
    pack), plus ``device``."""

    def __init__(self, max_batch=8, max_new_tokens=32, num_pages=None,
                 page_size=16, queue_capacity=None,
                 default_deadline_s=30.0, n_replicas=1,
                 restart_dead=True, max_attempts=None, eos_id=1,
                 kv_int8=None, drain_timeout_s=30.0,
                 metrics_port=None, trace_sample=None,
                 prefill_chunk=None, kv_share=None, spec_k=None,
                 draft_factory=None, preempt_slack_s=0.25,
                 collector=None, disagg_prefill=None,
                 n_prefill_replicas=1, device="cuda"):
        from paddle_tpu_torch.flags import get_flag

        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.max_new_tokens = int(max_new_tokens)
        self.page_size = int(page_size)
        # default pool: room for max_batch sequences of ~4 pages plus one
        # page of growth each — tight enough that the preemption path is
        # reachable, roomy enough that steady state never preempts
        self.num_pages = int(num_pages) if num_pages is not None \
            else 5 * self.max_batch
        self.queue_capacity = int(queue_capacity) \
            if queue_capacity is not None else 4 * self.max_batch
        self.default_deadline_s = float(default_deadline_s)
        self.n_replicas = int(n_replicas)
        self.restart_dead = bool(restart_dead)
        self.max_attempts = int(max_attempts) \
            if max_attempts is not None else 2 * self.n_replicas + 1
        self.eos_id = int(eos_id)
        self.kv_int8 = kv_int8      # None -> the typed flag
        self.drain_timeout_s = float(drain_timeout_s)
        # /metrics + /varz on this server (None ->
        # PADDLE_TPU_METRICS_PORT -> off; 0 = ephemeral)
        if metrics_port is None:
            metrics_port = metrics_port_from_env(None)
        self.metrics_port = None if metrics_port is None \
            else int(metrics_port)
        # fleet collector (same contract as ServingConfig.collector):
        # None -> PADDLE_TPU_COLLECTOR -> off
        if collector is None:
            collector = collector_endpoint()
        self.collector = collector
        if trace_sample is not None:
            trace_sample = float(trace_sample)
            if not 0.0 <= trace_sample <= 1.0:
                raise ValueError("trace_sample must be in [0.0, 1.0]")
        self.trace_sample = trace_sample
        # None defers to the typed flags, resolved once here
        self.prefill_chunk = int(get_flag("prefill_chunk")) \
            if prefill_chunk is None else int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        self.kv_share = kv_share    # None -> the typed flag (cache)
        self.spec_k = int(get_flag("spec_k")) if spec_k is None \
            else int(spec_k)
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        # draft_factory(i) -> draft model adapter (spec_k > 0 only);
        # None = a small TinyDecodeLM over the target's vocab
        self.draft_factory = draft_factory
        # deadline-aware preemption: a victim needs at least this much
        # deadline slack (plus a per-history-token allowance) to be
        # considered re-prefillable
        self.preempt_slack_s = float(preempt_slack_s)
        # disaggregated prefill/decode tiers: None defers to the typed
        # flag.  On: every decode replica reads one shared page pool,
        # prompt prefill runs on n_prefill_replicas workers of its own,
        # and a finished prefill reaches the decode tier as a page-list
        # handoff
        self.disagg_prefill = bool(get_flag("disagg_prefill")) \
            if disagg_prefill is None else bool(disagg_prefill)
        self.n_prefill_replicas = int(n_prefill_replicas)
        if self.n_prefill_replicas < 1:
            raise ValueError("n_prefill_replicas must be >= 1")
        if self.disagg_prefill and self.spec_k:
            raise ValueError(
                "disagg_prefill and spec_k are mutually exclusive (the "
                "speculative verify window stays single-tier)")


class _Seq:
    """One admitted sequence: request plus full token history (the
    failover unit: a survivor re-prefills from ``history``)."""

    __slots__ = ("req", "prompt", "generated", "max_new", "attempts",
                 "slot", "draft_slot", "chunk_pos", "last_token",
                 "last_emit_t", "trace")

    def __init__(self, req, prompt, max_new):
        self.req = req
        self.prompt = list(int(t) for t in prompt)
        self.generated = []
        self.max_new = int(max_new)
        self.attempts = 0
        self.slot = None
        self.draft_slot = None       # spec decode: the draft cache's
        self.chunk_pos = 0           # chunked prefill: prefix tokens
        #                              already written to the caches
        self.last_token = None
        self.last_emit_t = None
        self.trace = req.trace       # join/step/retire chain onto it

    def history(self):
        return self.prompt + self.generated


class _PrefillReplica:
    """One prefill-tier worker: a model adapter computing prompt
    projections and page writes into the shared pool.  No decode state;
    a kill loses only the handoff in flight (released, the sequence
    re-prefilled by a survivor)."""

    __slots__ = ("index", "model", "alive", "busy", "prefills",
                 "handoffs")

    def __init__(self, index, model):
        self.index = index
        self.model = model
        self.alive = True
        self.busy = False
        self.prefills = 0
        self.handoffs = 0


class _Handoff:
    """One in-flight prefill->decode transfer: the sequence, the
    detached page-list handle (host metadata only: physical page ids and
    token length), and the offer time the adoption-latency histogram
    reads."""

    __slots__ = ("seq", "handle", "offered_t")

    def __init__(self, seq, handle, offered_t):
        self.seq = seq
        self.handle = handle
        self.offered_t = offered_t


def _new_pool(cfg, model):
    return PagedKVCache(
        num_pages=cfg.num_pages, page_size=cfg.page_size,
        num_heads=model.num_heads, head_dim=model.head_dim,
        kv_int8=cfg.kv_int8, kv_share=cfg.kv_share, device=cfg.device)


class _DecodeReplica:
    """Model and paged cache (plus the draft model and its paged cache
    under spec_k) and the sequences currently riding it.  Under
    disaggregated serving every decode replica shares ONE pool
    (``cache`` given, ``owns_cache`` False), so a prefill-tier page list
    is adoptable by any of them with no bytes moved."""

    def __init__(self, index, model, cfg, draft_model=None, cache=None):
        self.index = index
        self.model = model
        self.cfg = cfg
        self.alive = True
        self.owns_cache = cache is None
        self.cache = cache if cache is not None else _new_pool(cfg, model)
        self.draft_model = draft_model
        self.draft_cache = None
        if draft_model is not None:
            self.draft_cache = PagedKVCache(
                num_pages=cfg.num_pages, page_size=cfg.page_size,
                num_heads=draft_model.num_heads,
                head_dim=draft_model.head_dim,
                kv_int8=cfg.kv_int8, kv_share=cfg.kv_share,
                device=cfg.device)
        self.active = []            # [_Seq], admission order
        self.prefilling = []        # [_Seq] mid-chunked-prefill
        self.iterations = 0
        self.tokens_out = 0


def _empty_kv(model):
    return torch.zeros((0, model.num_heads, model.head_dim))


class DecodeServer:
    """Continuous-batching decode server over N model replicas.

    model_factory(i) -> a model adapter for replica i (default:
    ``TinyDecodeLM`` per replica, same seed, on the config's device —
    replicas must agree so a failed-over sequence continues the same
    distribution)."""

    def __init__(self, model_factory=None, config=None):
        self.config = cfg = config or DecodeConfig()
        factory = model_factory or (
            lambda i: TinyDecodeLM(device=cfg.device))
        self.admission = AdmissionController(
            capacity=cfg.queue_capacity,
            default_deadline_s=cfg.default_deadline_s)
        # failover/preemption lane: unbounded on purpose (total sequences
        # stay bounded by admission capacity + max_batch * n_replicas)
        self._retry = BoundedQueue()
        # disaggregated tiers: ONE shared page pool that every decode
        # replica reads and the prefill tier writes, so the handoff is a
        # page-list move; the handoff queue is the tier boundary
        # (unbounded: its sequences already took admission capacity)
        self._disagg = bool(cfg.disagg_prefill)
        self._shared_cache = None
        self._handoff_q = BoundedQueue()
        if self._disagg:
            probe_model = factory(0)
            self._shared_cache = _new_pool(cfg, probe_model)
        self.replicas = []
        for i in range(cfg.n_replicas):
            model = probe_model if self._disagg and i == 0 else factory(i)
            draft = None
            if cfg.spec_k > 0:
                # replicas must agree on the draft too: a failed-over
                # sequence continues the same proposal distribution
                draft = cfg.draft_factory(i) if cfg.draft_factory \
                    else TinyDecodeLM(vocab=model.vocab, d_model=32,
                                      num_heads=2, head_dim=16, seed=0,
                                      device=cfg.device)
            self.replicas.append(_DecodeReplica(
                i, model, cfg, draft, cache=self._shared_cache))
        # the prefill tier's models at offset indices (the factory
        # contract: same-seed models agree with the decode tier, which
        # a failover's re-prefill depends on)
        self.prefill_replicas = []
        if self._disagg:
            self.prefill_replicas = [
                _PrefillReplica(i, factory(cfg.n_replicas + i))
                for i in range(cfg.n_prefill_replicas)]
        self._sup = Supervisor(restart_backoff=0.02, max_backoff=0.5)
        for rep in self.replicas:
            self._sup.add_worker("decode-%d" % rep.index,
                                 self._make_worker(rep),
                                 restart=cfg.restart_dead)
        for prep in self.prefill_replicas:
            self._sup.add_worker("prefill-%d" % prep.index,
                                 self._make_prefill_worker(prep),
                                 restart=cfg.restart_dead)
        self._meta = {}             # req.id -> max_new
        self._lock = threading.Lock()
        self._counters = {"iterations": 0, "tokens_out": 0,
                          "prefills": 0, "prefill_chunks": 0,
                          "kills": 0, "step_faults": 0,
                          "failovers": 0, "preemptions": 0,
                          "spec_proposed": 0, "spec_accepted": 0,
                          "handoffs_offered": 0, "handoffs_adopted": 0,
                          "handoffs_lost": 0, "handoffs_expired": 0,
                          "prefill_kills": 0}
        self._step_ms = []          # bounded rolling inter-token record
        self.metrics_server = None
        self.collector_pusher = None
        self._started = False
        self._stopped = False

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if not self._started:
            self._started = True
            if self.config.trace_sample is not None:
                _trace.set_sample_rate(self.config.trace_sample)
            if self.config.metrics_port is not None:
                try:
                    self.metrics_server = MetricsHTTPServer(
                        port=self.config.metrics_port).start()
                except OSError:
                    self.metrics_server = None
            if self.config.collector:
                self.collector_pusher = CollectorPusher(
                    self.config.collector, role="decode").start()
            self._sup.start()
            self._export_tier_gauges()
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- request path -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=None, deadline_s=None,
               request_id=None):
        """Admit a decode request (prompt token ids, 1-D int array) or
        raise a typed ServingError.  The Request future resolves to
        ``[generated_tokens]`` (np.int32, <= max_new_tokens, eos included
        when emitted).  With tracing on, this is the root span of the
        sequence's trace (``decode.submit``)."""
        if _trace._tracer is not None:
            with _trace._tracer.span("decode.submit",
                                     request_id=request_id):
                return self._submit_inner(prompt_ids, max_new_tokens,
                                          deadline_s, request_id)
        return self._submit_inner(prompt_ids, max_new_tokens,
                                  deadline_s, request_id)

    def _submit_inner(self, prompt_ids, max_new_tokens, deadline_s,
                      request_id):
        if not self._started or self._stopped:
            self.admission._count("rejected_shutdown")
            raise ShutdownError("decode server not running")
        if not any(r.alive for r in self.replicas):
            self.admission._count("rejected_overloaded")
            raise ReplicaFailedError("no live decode replicas")
        ids = np.asarray(prompt_ids)
        if ids.ndim != 1 or ids.size == 0 or \
                not np.issubdtype(ids.dtype, np.integer):
            raise ValueError(
                "prompt_ids must be a non-empty 1-D integer array, "
                "got shape %s dtype %s" % (ids.shape, ids.dtype))
        vocab = self.replicas[0].model.vocab
        if ids.min() < 0 or ids.max() >= vocab:
            raise ValueError("prompt token out of range [0, %d)" % vocab)
        max_new = int(max_new_tokens) if max_new_tokens is not None \
            else self.config.max_new_tokens
        cache0 = self.replicas[0].cache
        # spec decoding transiently appends k+1 tokens before the
        # rejection rewind — the capacity check carries that margin
        margin = self.config.spec_k + 1 if self.config.spec_k else 0
        if cache0.pages_for(ids.size + max_new + margin) > \
                cache0.num_pages:
            raise ValueError(
                "prompt+max_new needs %d pages; the pool only has %d"
                % (cache0.pages_for(ids.size + max_new + margin),
                   cache0.num_pages))
        req = self.admission.submit({"ids": ids.astype(np.int32)},
                                    deadline_s=deadline_s,
                                    request_id=request_id)
        with self._lock:
            self._meta[req.id] = max_new
        return req

    def decode(self, prompt_ids, max_new_tokens=None, deadline_s=None,
               timeout=None):
        """Synchronous convenience: submit + result -> np token array."""
        req = self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                          deadline_s=deadline_s)
        return req.result(timeout=timeout)[0]

    # -- the iteration loop -------------------------------------------------
    def _make_worker(self, rep):
        def loop():
            # a supervisor relaunch IS the replica restart
            # (restart_dead=True); the cache was reset at kill time
            if not rep.alive and self.config.restart_dead:
                rep.alive = True
            while self._sup.running:
                if not rep.alive:
                    return
                self._admit(rep)
                if not rep.active and not rep.prefilling:
                    if self.admission.draining and self._retry.empty():
                        time.sleep(0.002)
                    time.sleep(0.001)
                    continue
                try:
                    self._iterate(rep)
                except ReplicaKilled:
                    raise     # worker dies; supervisor may relaunch
                except Exception:
                    # a step that failed for any other reason fails over
                    # its sequences rather than dying silently
                    self._fail_over(rep)
                    raise

        return loop

    def _next_seq(self):
        """Pop the next sequence needing (re-)prefill: the failover /
        preemption lane first, then fresh admissions."""
        try:
            return self._retry.get_nowait()
        except queue_mod.Empty:
            req = self.admission.take(timeout=0.0005)
            if req is None:
                return None
            with self._lock:
                max_new = self._meta.get(req.id,
                                         self.config.max_new_tokens)
            return _Seq(req, np.asarray(req.feeds["ids"]), max_new)

    def _admit(self, rep):
        """Join new and failed-over sequences into this replica's batch
        (iteration-level batching: called every step).  Under
        disaggregated serving the decode tier joins only adopted
        handoffs: raw admissions and re-prefills belong to the prefill
        tier."""
        if self._disagg:
            return self._admit_handoffs(rep)
        cfg = self.config
        while len(rep.active) + len(rep.prefilling) < cfg.max_batch:
            seq = self._next_seq()
            if seq is None:
                return
            now = time.monotonic()
            if seq.req.done():
                continue            # answered elsewhere (drain sweep)
            if seq.req.expired(now):
                seq.req.fail(DeadlineExpiredError(
                    "request %s: deadline passed before joining the "
                    "decode batch" % seq.req.id))
                continue
            if seq.attempts >= cfg.max_attempts:
                seq.req.fail(ReplicaFailedError(
                    "sequence failed after %d attempts" % seq.attempts))
                continue
            try:
                ready = self._prefill(rep, seq)
            except OutOfPagesError:
                # no room: back on the lane for later / for a less
                # loaded replica (not an attempt — nothing failed)
                self._retry.put(seq)
                return
            if _trace._tracer is not None:
                sp = _trace._tracer.instant(
                    "decode.join", parent=seq.trace,
                    request_id=seq.req.id, replica=rep.index,
                    prompt_len=len(seq.prompt), attempt=seq.attempts,
                    chunked=not ready)
                if seq.trace is not None:
                    seq.trace = sp.ctx
            _flight.record("decode", "join", request_id=seq.req.id,
                           replica=rep.index, prompt_len=len(seq.prompt),
                           chunked=not ready)
            (rep.active if ready else rep.prefilling).append(seq)

    # -- disaggregated tiers -------------------------------------------------
    def _admit_handoffs(self, rep):
        """Decode-tier join: adopt offered page-list handoffs into this
        replica's running batch (``PagedKVCache.adopt``: block-table
        entries reinstated on a fresh slot, no device bytes moved).  The
        deadline crosses the tier boundary: a handoff whose request
        expired in transit is released (pages freed) and answered with
        the typed expiry, never parked."""
        cfg = self.config
        while len(rep.active) < cfg.max_batch:
            try:
                h = self._handoff_q.get_nowait()
            except queue_mod.Empty:
                return
            seq = h.seq
            now = time.monotonic()
            with rep.cache.lock:
                if seq.req.done():
                    rep.cache.release_in_transit(h.handle)
                    self._count_handoff("orphaned")
                    continue
                if seq.req.expired(now):
                    rep.cache.release_in_transit(h.handle)
                    self._count_handoff("expired")
                    self._count(handoffs_expired=1)
                    seq.req.fail(DeadlineExpiredError(
                        "request %s: deadline passed in the "
                        "prefill->decode handoff" % seq.req.id))
                    continue
                try:
                    seq.slot = rep.cache.adopt(h.handle)
                except OutOfPagesError:
                    # no free sequence slot now: the handle stays in
                    # transit, offered again to a later iteration or
                    # another replica
                    self._handoff_q.put(h)
                    return
            seq.last_token = int(seq.history()[-1])
            seq.last_emit_t = now
            self._count(handoffs_adopted=1)
            self._count_handoff("adopted", latency_s=now - h.offered_t,
                                trace=seq.trace)
            if _trace._tracer is not None:
                sp = _trace._tracer.instant(
                    "decode.adopt", parent=seq.trace,
                    request_id=seq.req.id, replica=rep.index,
                    pages=len(h.handle["pages"]),
                    handoff_ms=round((now - h.offered_t) * 1e3, 3))
                if seq.trace is not None:
                    seq.trace = sp.ctx
            _flight.record("decode", "handoff_adopted",
                           request_id=seq.req.id, replica=rep.index,
                           pages=len(h.handle["pages"]))
            rep.active.append(seq)

    def _make_prefill_worker(self, prep):
        """Prefill-tier worker loop: take a sequence from the retry lane
        or admission, write its prompt K/V into the shared pool, detach
        the pages into a handoff and offer it to the decode tier."""
        def loop():
            if not prep.alive and self.config.restart_dead:
                prep.alive = True
            while self._sup.running:
                if not prep.alive:
                    return
                seq = self._next_seq()
                if seq is None:
                    time.sleep(0.001)
                    continue
                now = time.monotonic()
                if seq.req.done():
                    continue            # answered elsewhere
                if seq.req.expired(now):
                    seq.req.fail(DeadlineExpiredError(
                        "request %s: deadline passed before prefill"
                        % seq.req.id))
                    continue
                if seq.attempts >= self.config.max_attempts:
                    seq.req.fail(HandoffError(
                        "request %s: handoff/prefill failed after %d "
                        "attempts" % (seq.req.id, seq.attempts)))
                    continue
                prep.busy = True
                try:
                    self._prefill_handoff(prep, seq)
                finally:
                    prep.busy = False
        return loop

    def _prefill_handoff(self, prep, seq):
        """ONE prefill: project the prompt prefix, write it into the
        shared pool, detach the page list, consult the fault plan
        (MSG_PREFILL, the window after allocation and before adoption),
        offer the handoff.  Raises ReplicaKilled on an injected kill
        (the worker dies; the sequence re-prefills elsewhere)."""
        cache = self._shared_cache
        hist = seq.history()
        prefix = hist[:-1]
        # projections outside the pool lock; page writes and the detach
        # inside it
        if prefix:
            shared = cache.shared_prefix_tokens(prefix)
            tail = prefix[shared:]
            k, v = self._proj_pow2(prep.model, tail) if tail \
                else (_empty_kv(prep.model),) * 2
        try:
            with cache.lock:
                if prefix:
                    slot = cache.prefill(
                        k, v, tokens=prefix if cache.kv_share else None)
                else:
                    slot = cache.alloc(1)
                handle = cache.detach(slot)
        except OutOfPagesError:
            # pool pressure: nothing allocated (prefill is atomic); back
            # on the lane until the decode tier retires pages
            self._retry.put(seq)
            time.sleep(0.002)
            return
        except ValueError:
            # kv_share race: another prefill registered more shared pages
            # between our radix walk and the locked write, so the
            # projected tail no longer fits; project again
            self._retry.put(seq)
            return
        prep.prefills += 1
        self._count(prefills=1)
        # the seeded fault point: pages allocated and in transit, not
        # adopted yet
        inj = faultinject.maybe_injector()
        if inj is not None:
            act = inj.decide(MSG_PREFILL)
            if act is not None:
                for kind, arg in faultinject.steps_of(act):
                    if kind == "delay":
                        time.sleep(arg)
                        continue
                    with cache.lock:
                        cache.release_in_transit(handle)
                    seq.attempts += 1
                    if kind == "kill":
                        prep.alive = False
                        self._count(kills=1, prefill_kills=1)
                        self._count_handoff("killed")
                        self._requeue_or_fail_handoff(seq)
                        self._export_tier_gauges()
                        _flight.record("decode", "prefill_replica_killed",
                                       replica=prep.index,
                                       request_id=seq.req.id)
                        _flight.dump(reason="prefill_replica_death")
                        raise ReplicaKilled(
                            "prefill replica %d killed mid-handoff "
                            "(fault injection)" % prep.index)
                    # close / drop / truncate: the handoff is lost in
                    # transit; pages freed, the sequence re-prefills
                    # (exactly-once holds: only the Request answers)
                    self._count(handoffs_lost=1)
                    self._count_handoff("lost")
                    self._requeue_or_fail_handoff(seq)
                    return
        h = _Handoff(seq, handle, time.monotonic())
        prep.handoffs += 1
        self._count(handoffs_offered=1)
        self._count_handoff("offered")
        _flight.record("decode", "handoff_offered", request_id=seq.req.id,
                       replica=prep.index, pages=len(handle["pages"]),
                       tokens=handle["length"])
        self._handoff_q.put(h)
        self._export_tier_gauges()

    def _requeue_or_fail_handoff(self, seq):
        """The re-prefill fallback: the sequence goes back on the lane
        unless its attempt budget is spent (the typed HandoffError)."""
        if seq.req.done():
            return
        if seq.attempts >= self.config.max_attempts:
            seq.req.fail(HandoffError(
                "request %s: handoff lost %d times; giving up"
                % (seq.req.id, seq.attempts)))
        else:
            self._count(failovers=1)
            self._retry.put(seq)

    def _count_handoff(self, outcome, latency_s=None, trace=None):
        _M_HANDOFFS.inc(outcome=outcome)
        if latency_s is not None:
            exemplar = None
            if _trace._tracer is not None and trace is not None \
                    and _trace._tracer._head_sampled(trace[0]):
                exemplar = trace[0]
            _M_HANDOFF_SECONDS.observe(latency_s, exemplar=exemplar)

    def _export_tier_gauges(self):
        if not self._disagg:
            return
        _G_TIER_REPLICAS.set(
            sum(1 for p in self.prefill_replicas if p.alive),
            tier="prefill")
        _G_TIER_REPLICAS.set(sum(1 for r in self.replicas if r.alive),
                             tier="decode")
        c = self._shared_cache
        _G_TIER_PAGES.set(c.in_use_pages(), kind="in_use")
        _G_TIER_PAGES.set(c.in_transit_pages(), kind="in_transit")
        _G_TIER_PAGES.set(c.free_pages(), kind="free")

    @staticmethod
    def _proj_pow2(model, toks):
        """Whole-prefill projections at the span padded to a power of two
        (the JAX package's fixed-shape discipline, kept so the shapes
        and the tests match), real rows sliced out."""
        plen = len(toks)
        pp = 1
        while pp < plen:
            pp *= 2
        padded = np.zeros((pp,), np.int32)
        padded[:plen] = toks
        _, k, v = model.qkv(padded)
        return k[:plen], v[:plen]

    @staticmethod
    def _proj_chunk(model, toks, chunk):
        """Chunked-prefill projections, always at exactly the chunk
        shape (the final partial chunk pads up to it)."""
        plen = len(toks)
        padded = np.zeros((chunk,), np.int32)
        padded[:plen] = toks
        _, k, v = model.qkv(padded)
        return k[:plen], v[:plen]

    def _release_seq(self, rep, seq):
        """Free whatever cache state the sequence holds on this replica
        (both caches under spec_k); resets the chunk cursor so a
        re-prefill starts clean.  Under the pool's lock: the
        disaggregated tiers share one pool across worker threads."""
        with rep.cache.lock:
            if seq.slot is not None:
                rep.cache.free(seq.slot)
                seq.slot = None
        if seq.draft_slot is not None and rep.draft_cache is not None:
            rep.draft_cache.free(seq.draft_slot)
        seq.draft_slot = None
        seq.chunk_pos = 0

    def _prefill(self, rep, seq):
        """Write KV for history[:-1] into fresh pages (both caches under
        spec_k); the last history token becomes the pending input of the
        next iteration.  True when the sequence is decode-ready, False
        when its prompt continues chunk by chunk in _advance_prefill.
        Under kv_share the already-cached full-page prefix is shared
        instead of projected or written."""
        cfg = self.config
        hist = seq.history()
        prefix = hist[:-1]
        try:
            if not prefix:
                seq.slot = rep.cache.alloc(1)
                if rep.draft_cache is not None:
                    seq.draft_slot = rep.draft_cache.alloc(1)
            else:
                shared = rep.cache.shared_prefix_tokens(prefix)
                chunk = cfg.prefill_chunk
                if chunk and len(prefix) - shared > chunk:
                    span = prefix[:shared + chunk]
                else:
                    span = prefix
                tail = span[shared:]
                if not tail:
                    # fully shared: zero projections, zero writes
                    k = v = _empty_kv(rep.model)
                elif chunk:
                    # every chunked projection runs at the one fixed
                    # chunk shape (tail <= chunk by the span cap)
                    k, v = self._proj_chunk(rep.model, tail, chunk)
                else:
                    k, v = self._proj_pow2(rep.model, tail)
                seq.slot = rep.cache.prefill(
                    k, v, tokens=span if rep.cache.kv_share else None)
                if rep.draft_cache is not None:
                    dm = rep.draft_cache.shared_prefix_tokens(span)
                    kd, vd = self._proj_pow2(rep.draft_model, span[dm:]) \
                        if len(span) > dm else \
                        (_empty_kv(rep.draft_model),) * 2
                    seq.draft_slot = rep.draft_cache.prefill(
                        kd, vd,
                        tokens=span if rep.draft_cache.kv_share else None)
                if len(span) < len(prefix):
                    seq.chunk_pos = len(span)
                    self._count(prefill_chunks=1)
                    return False
        except OutOfPagesError:
            self._release_seq(rep, seq)
            raise
        seq.chunk_pos = 0
        seq.last_token = int(hist[-1])
        seq.last_emit_t = time.monotonic()
        self._count(prefills=1)
        return True

    def _advance_prefill(self, rep):
        """One fixed-size prefill chunk per iteration for the OLDEST
        joining sequence: the cost a long prompt adds to every running
        stream's inter-token time is bounded by one chunk."""
        if not rep.prefilling:
            return
        cfg = self.config
        seq = rep.prefilling[0]
        prefix = seq.history()[:-1]
        span = prefix[seq.chunk_pos:seq.chunk_pos + cfg.prefill_chunk]
        try:
            k, v = self._proj_chunk(rep.model, span, cfg.prefill_chunk)
            rep.cache.extend(
                seq.slot, k, v,
                tokens=prefix[:seq.chunk_pos + len(span)]
                if rep.cache.kv_share else None)
            if rep.draft_cache is not None:
                kd, vd = self._proj_chunk(rep.draft_model, span,
                                          cfg.prefill_chunk)
                rep.draft_cache.extend(
                    seq.draft_slot, kd, vd,
                    tokens=prefix[:seq.chunk_pos + len(span)]
                    if rep.draft_cache.kv_share else None)
        except OutOfPagesError:
            # pool pressure mid-prefill: whole sequence back on the lane
            # (pages freed — nothing half-joined)
            rep.prefilling.pop(0)
            self._release_seq(rep, seq)
            self._retry.put(seq)
            return
        seq.chunk_pos += len(span)
        self._count(prefill_chunks=1)
        if seq.chunk_pos >= len(prefix):
            rep.prefilling.pop(0)
            seq.chunk_pos = 0
            seq.last_token = int(seq.history()[-1])
            seq.last_emit_t = time.monotonic()
            self._count(prefills=1)
            rep.active.append(seq)

    def _iterate(self, rep):
        """ONE iteration: advance at most one prefill chunk, then one
        decode step (plain or speculative) for the whole running
        batch."""
        cfg = self.config
        # seeded fault point — consulted BEFORE any cache mutation so
        # kill/close/drop can never half-apply a step
        inj = faultinject.maybe_injector()
        if inj is not None:
            act = inj.decide(MSG_DECODE)
            if act is not None:
                for kind, arg in faultinject.steps_of(act):
                    if kind == "delay":
                        time.sleep(arg)
                    elif kind == "kill":
                        self._count(kills=1)
                        self._fail_over(rep)
                        raise ReplicaKilled(
                            "decode replica %d killed mid-step "
                            "(fault injection)" % rep.index)
                    else:   # close / drop / truncate: lost step —
                        # transient, nothing mutated yet, no token
                        # emitted this iteration; the next one retries
                        self._count(step_faults=1)
                        return
        now = time.monotonic()
        # deadline / externally-answered sweep before spending compute
        # (joining chunked sequences expire mid-prefill the same way)
        for lane_name in ("active", "prefilling"):
            lane = getattr(rep, lane_name)
            keep = []
            for s in lane:
                if s.req.done():
                    self._release_seq(rep, s)
                elif s.req.expired(now):
                    self._release_seq(rep, s)
                    s.req.fail(DeadlineExpiredError(
                        "request %s: deadline passed mid-generation "
                        "(%d/%d tokens emitted)"
                        % (s.req.id, len(s.generated), s.max_new)))
                else:
                    keep.append(s)
            setattr(rep, lane_name, keep)
        self._advance_prefill(rep)
        if not rep.active:
            return
        if cfg.spec_k > 0:
            self._step_spec(rep)
        else:
            self._step(rep)
        st = rep.cache.stats()
        _M_PAGE_UTIL.set(
            st["in_use_pages"] / float(max(1, st["num_pages"])),
            replica=rep.index)
        _M_ACTIVE.set(len(rep.active), replica=rep.index)

    def _preempt_victim(self, rep, now):
        """Deadline-aware victim index: youngest to oldest, the first
        sequence whose deadline can absorb a re-prefill (slack >
        preempt_slack_s + 1 ms a history token); when every candidate is
        at risk, the youngest."""
        slack = self.config.preempt_slack_s
        for idx in range(len(rep.active) - 1, -1, -1):
            s = rep.active[idx]
            if s.req.remaining(now) > slack + 0.001 * len(s.history()):
                return idx
        return len(rep.active) - 1

    def _preempt_one(self, rep):
        """Evict one sequence under pool pressure (full history preserved
        on the retry lane); False when the batch is down to a lone
        unservable sequence (typed failure, step abandoned)."""
        if len(rep.active) == 1:
            s = rep.active.pop()
            self._release_seq(rep, s)
            s.req.fail(ReplicaFailedError(
                "request %s: page pool too small even for a lone "
                "sequence" % s.req.id))
            return False
        s = rep.active.pop(self._preempt_victim(rep, time.monotonic()))
        self._release_seq(rep, s)
        self._count(preemptions=1)
        _flight.record("decode", "preempt", request_id=s.req.id,
                       replica=rep.index, tokens_so_far=len(s.generated))
        self._retry.put(s)
        return True

    def _table_bucket(self, cache, slots):
        """Table width padded to a power of two, clamped to the table
        itself (the JAX package's compile-once bucket, kept so the
        launch shapes match)."""
        mp_need = max(cache.pages_for(cache.seq_len(s_) or 1)
                      for s_ in slots)
        mp = 1
        while mp < mp_need:
            mp *= 2
        return min(mp, cache.max_pages_per_seq)

    def _attend(self, cache, q, slots, n_pad):
        """flash_decode of ``q`` over ``slots``' pages, at the fixed
        batch shape ``n_pad`` (dummy rows have length 0 and emit 0)."""
        with cache.lock:
            mp = self._table_bucket(cache, slots)
            tables = cache.tables_for(slots, max_pages=mp, pad_to=n_pad)
            lens = cache.lens_for(slots, pad_to=n_pad)
        return flash_decode(
            q, cache.k_pages, cache.v_pages, tables, lens,
            kv_scales=cache.kv_scales() if cache.kv_int8 else None)

    def _step(self, rep):
        """ONE decode step for the whole running batch, at the fixed
        batch shape max_batch (dummy rows write the sink page)."""
        n_pad = self.config.max_batch
        while True:
            tokens = np.zeros((n_pad,), np.int32)
            tokens[:len(rep.active)] = [s.last_token for s in rep.active]
            q, k, v = rep.model.qkv(tokens)
            slots = [s.slot for s in rep.active]
            try:
                with rep.cache.lock:
                    rep.cache.append(slots, k, v)
                break
            except OutOfPagesError:
                # paging backpressure: preempt (deadline-aware) and retry
                if not self._preempt_one(rep):
                    return
        out = self._attend(rep.cache, q, slots, n_pad)
        # the greedy head: one definition for step, draft and verify; the
        # host needs the tokens, so this is where a step synchronises
        next_tokens = greedy_logits_tail(rep.model.logits(out)).cpu() \
            .numpy()
        t_emit = time.monotonic()
        rep.iterations += 1
        still = []
        for s, tok in zip(rep.active, next_tokens):
            if not self._commit_tokens(rep, s, [int(tok)], t_emit):
                still.append(s)
        rep.active = still
        self._count(iterations=1, tokens_out=len(next_tokens))

    def _commit_tokens(self, rep, s, toks, t_emit):
        """Append emitted tokens to a sequence's bookkeeping (never
        touches the caches); True when the sequence retired (pages
        freed, future answered)."""
        cfg = self.config
        tr = _trace._tracer
        per_tok_ms = None
        if s.last_emit_t is not None:
            per_tok_ms = (t_emit - s.last_emit_t) * 1000.0 / len(toks)
        done = False
        for tok in toks:
            s.generated.append(tok)
            s.last_token = tok
            if per_tok_ms is not None:
                self._record_step_ms(per_tok_ms)
            rep.tokens_out += 1
            if tr is not None:
                tr.instant("decode.step", parent=s.trace,
                           request_id=s.req.id, replica=rep.index,
                           token=tok, n=len(s.generated))
            if tok == cfg.eos_id or len(s.generated) >= s.max_new:
                done = True
        s.last_emit_t = t_emit
        if done:
            self._release_seq(rep, s)
            if tr is not None:
                tr.instant("decode.retire", parent=s.trace,
                           request_id=s.req.id, replica=rep.index,
                           tokens=len(s.generated))
            _flight.record("decode", "retire", request_id=s.req.id,
                           replica=rep.index, tokens=len(s.generated))
            self._count(retires=1)
            s.req.complete([np.asarray(s.generated, np.int32)])
        return done

    def _step_spec(self, rep):
        """ONE speculative iteration: k draft proposals, one
        q-len-(k+1) verify sweep, longest-agreeing-prefix acceptance,
        page-pointer rewind of the rejected tail.  An OutOfPagesError
        mid-round rewinds BOTH caches to the iteration's start state,
        preempts one sequence and retries."""
        while True:
            if not rep.active:
                return
            base = [(s, rep.cache.seq_len(s.slot),
                     rep.draft_cache.seq_len(s.draft_slot))
                    for s in rep.active]
            try:
                self._spec_round(rep)
                return
            except OutOfPagesError:
                for s, main_len, draft_len in base:
                    if s.slot is not None and \
                            rep.cache.seq_len(s.slot) > main_len:
                        rep.cache.truncate(s.slot, main_len)
                    if s.draft_slot is not None and \
                            rep.draft_cache.seq_len(s.draft_slot) > \
                            draft_len:
                        rep.draft_cache.truncate(s.draft_slot, draft_len)
                if not self._preempt_one(rep):
                    return

    def _spec_round(self, rep):
        from paddle_tpu_torch.decode import spec_accept_length

        cfg = self.config
        kk = cfg.spec_k
        n_pad = cfg.max_batch
        live = rep.active
        n = len(live)
        draft = rep.draft_model
        dcache = rep.draft_cache
        # --- draft phase: k sequential q-len-1 proposals on the draft
        # replica's own paged cache (fixed shapes throughout)
        pending = np.zeros((n_pad,), np.int32)
        pending[:n] = [s.last_token for s in live]
        dslots = [s.draft_slot for s in live]
        proposals = np.zeros((n_pad, kk), np.int32)
        cur = pending.copy()
        for j in range(kk):
            q, dk, dv = draft.qkv(cur)
            dcache.append(dslots, dk, dv)
            out = self._attend(dcache, q, dslots, n_pad)
            cur = greedy_logits_tail(draft.logits(out)).cpu().numpy() \
                .astype(np.int32)
            proposals[:, j] = cur
        # --- verify phase: ONE batched q-len-(k+1) target sweep over
        # [pending, d_1..d_k] — the whole window appends first, then
        # every row scores in one kernel pass
        r = kk + 1
        window = np.zeros((n_pad, r), np.int32)
        window[:n, 0] = pending[:n]
        window[:n, 1:] = proposals[:n]
        h, d = rep.model.num_heads, rep.model.head_dim
        q, mk, mv = rep.model.qkv(window.reshape(-1))
        q = q.reshape(n_pad, r, h, d)
        mk = mk.reshape(n_pad, r, h, d)
        mv = mv.reshape(n_pad, r, h, d)
        slots = [s.slot for s in live]
        rep.cache.append(slots, mk, mv)
        out = self._attend(rep.cache, q, slots, n_pad)
        logits = rep.model.logits(out.reshape(n_pad * r, h, d))
        targets = greedy_logits_tail(logits).cpu().numpy().reshape(n_pad, r)
        # --- acceptance and cache rewind (still abortable: sequence
        # bookkeeping is untouched until the commit loop below)
        plan = []
        catch_up = []
        for i, s in enumerate(live):
            m = spec_accept_length(proposals[i], targets[i])
            emitted = [int(t) for t in targets[i, :m + 1]]
            room = s.max_new - len(s.generated)
            if len(emitted) > room:
                emitted = emitted[:room]
            if cfg.eos_id in emitted:
                emitted = emitted[:emitted.index(cfg.eos_id) + 1]
            n_emit = len(emitted)
            plan.append((s, emitted, m))
            base_main = rep.cache.seq_len(s.slot) - r
            rep.cache.truncate(s.slot, base_main + n_emit)
            base_draft = dcache.seq_len(s.draft_slot) - kk
            dcache.truncate(s.draft_slot,
                            min(base_draft + kk, base_draft + n_emit))
            if n_emit == kk + 1:
                # full acceptance: the draft cache is one row short (d_k
                # was proposed but never appended draft-side)
                catch_up.append((s, int(proposals[i, kk - 1])))
        if catch_up:
            toks = np.zeros((n_pad,), np.int32)
            toks[:len(catch_up)] = [t for _, t in catch_up]
            _, dk, dv = draft.qkv(toks)
            dcache.append([s.draft_slot for s, _ in catch_up], dk, dv)
        # --- commit (never raises): emitted tokens, timers, retires
        t_emit = time.monotonic()
        rep.iterations += 1
        total = 0
        accepted = 0
        still = []
        for s, emitted, m in plan:
            total += len(emitted)
            # acceptance counts draft agreement (the draft-quality
            # signal), not emission
            accepted += m
            if not self._commit_tokens(rep, s, emitted, t_emit):
                still.append(s)
        rep.active = still
        self._count(iterations=1, tokens_out=total,
                    spec_proposed=kk * n, spec_accepted=accepted)

    def _fail_over(self, rep):
        """Kill path: every live sequence (full token history) onto the
        retry lane; the dead replica's cache state is released (all its
        pages freed, accounting intact).  A replica that owns its cache
        resets it; a disaggregated replica shares the pool with live
        tiers, so only its sequences' slots are freed (a decode kill
        right after adoption frees the adopted pages, and the prefill
        tier re-prefills from token history)."""
        rep.alive = False
        moved = rep.active + rep.prefilling
        rep.active = []
        rep.prefilling = []
        if rep.owns_cache:
            rep.cache.reset()
        else:
            for s in moved:
                self._release_seq(rep, s)
        if rep.draft_cache is not None:
            rep.draft_cache.reset()
        self._export_tier_gauges()
        _flight.record("decode", "replica_killed", replica=rep.index,
                       live_seqs=len(moved))
        # post-mortem: the ring holds the chaos action, the kill and
        # every join/preempt that led here
        _flight.dump(reason="decode_replica_death")
        survivors = [r for r in self.replicas
                     if r.alive and r is not rep] \
            or ([rep] if self.config.restart_dead else [])
        for s in moved:
            s.slot = None
            s.draft_slot = None
            s.chunk_pos = 0
            s.attempts += 1
            if s.req.done():
                continue
            if not survivors and s.attempts >= self.config.max_attempts:
                s.req.fail(ReplicaFailedError(
                    "replica died; no survivors after %d attempts"
                    % s.attempts))
            else:
                self._count(failovers=1)
                self._retry.put(s)

    # -- shutdown -----------------------------------------------------------
    def drain(self, timeout=None):
        """Stop admitting; run every admitted sequence to completion (or
        typed expiry); answer whatever remains at the timeout with the
        typed ShutdownError.  Returns the shutdown-failed count."""
        timeout = self.config.drain_timeout_s if timeout is None \
            else float(timeout)
        self.admission.start_drain()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            busy = any(r.active or r.prefilling for r in self.replicas) \
                or not self._retry.empty() \
                or not self._handoff_q.empty() \
                or any(p.busy for p in self.prefill_replicas) \
                or self.admission.outstanding_count() > 0
            if not busy:
                break
            time.sleep(0.005)
        leftovers = self.admission.outstanding()
        for req in leftovers.values():
            req.fail(ShutdownError(
                "request %s: decode server drained before completion"
                % req.id))
        return len(leftovers)

    def stop(self, drain_timeout=None):
        if self._stopped:
            return 0
        leftovers = self.drain(timeout=drain_timeout)
        self._stopped = True
        self._sup.stop(join_timeout=2.0)
        # post-drain page sweep: sequences answered by the drain above
        # still hold pages until their worker notices — workers are
        # stopped now, so release here; the accounting check runs after
        # this (a page owned by no sequence is not maskable by it)
        for rep in self.replicas:
            for s in rep.active + rep.prefilling:
                self._release_seq(rep, s)
            rep.active = []
            rep.prefilling = []
        # the disaggregated sweep: handoffs never adopted (their requests
        # were answered by the drain above) still hold pages; release
        # every queued offer and any straggler in transit
        if self._shared_cache is not None:
            while True:
                try:
                    h = self._handoff_q.get_nowait()
                except queue_mod.Empty:
                    break
                with self._shared_cache.lock:
                    self._shared_cache.release_in_transit(h.handle)
            with self._shared_cache.lock:
                self._shared_cache.release_in_transit()
            self._export_tier_gauges()
        if self.collector_pusher is not None:
            self.collector_pusher.stop(final_push=True)
            self.collector_pusher = None
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        return leftovers

    # -- observability ------------------------------------------------------
    def _count(self, **incs):
        with self._lock:
            for k_, v_ in incs.items():
                # registry-only events (retires) keep the public counters
                # dict's keys fixed
                if k_ in self._counters:
                    self._counters[k_] += v_
        for k_, v_ in incs.items():
            _M_DECODE.inc(v_, event=k_)

    def _record_step_ms(self, ms):
        with self._lock:
            self._step_ms.append(ms)
            if len(self._step_ms) > 10000:
                del self._step_ms[:5000]
        _M_STEP_MS.observe(ms / 1000.0)

    def inter_token_ms(self):
        """(p50, p99) inter-token latency over the rolling record."""
        with self._lock:
            lat = sorted(self._step_ms)
        if not lat:
            return None, None
        return (lat[min(len(lat) - 1, int(0.50 * len(lat)))],
                lat[min(len(lat) - 1, int(0.99 * len(lat)))])

    def page_accounting(self):
        """(ok, detail) over every replica cache — the zero-leak
        invariant (``allocated == in_use + free``, and in_use == 0 after
        drain)."""
        for rep in self.replicas:
            ok, detail = rep.cache.check_accounting()
            if not ok:
                return False, "replica %d: %s" % (rep.index, detail)
            if rep.draft_cache is not None:
                ok, detail = rep.draft_cache.check_accounting()
                if not ok:
                    return False, ("replica %d draft cache: %s"
                                   % (rep.index, detail))
        return True, ""

    def stats(self):
        c = self.admission.counters()
        answered = sum(v for k_, v in c.items()
                       if k_.startswith("answered_"))
        with self._lock:
            counters = dict(self._counters)
        p50, p99 = self.inter_token_ms()
        acceptance = None
        if counters.get("spec_proposed"):
            acceptance = round(counters["spec_accepted"]
                               / counters["spec_proposed"], 4)
        disagg = None
        if self._disagg:
            sc = self._shared_cache
            disagg = {
                "prefill_replicas": {
                    p.index: {"alive": p.alive, "prefills": p.prefills,
                              "handoffs": p.handoffs}
                    for p in self.prefill_replicas},
                "handoff_queue": self._handoff_q.qsize(),
                "handoffs_offered": counters["handoffs_offered"],
                "handoffs_adopted": counters["handoffs_adopted"],
                "handoffs_lost": counters["handoffs_lost"],
                "handoffs_expired": counters["handoffs_expired"],
                "prefill_kills": counters["prefill_kills"],
                "in_transit_pages": sc.in_transit_pages(),
                "shared_pool": sc.stats(),
            }
        return {
            "spec_acceptance_rate": acceptance,
            "disagg": disagg,
            "admission": c,
            "outstanding": self.admission.outstanding_count(),
            "answered": answered,
            "accounted": answered + self.admission.outstanding_count()
            == c["admitted"],
            "decode": counters,
            "inter_token_p50_ms": p50,
            "inter_token_p99_ms": p99,
            "retry_depth": self._retry.qsize(),
            "replicas": {
                rep.index: {"alive": rep.alive,
                            "active_seqs": len(rep.active),
                            "prefilling_seqs": len(rep.prefilling),
                            "iterations": rep.iterations,
                            "tokens_out": rep.tokens_out,
                            "cache": rep.cache.stats(),
                            **({"draft_cache": rep.draft_cache.stats()}
                               if rep.draft_cache is not None else {})}
                for rep in self.replicas},
            "draining": self.admission.draining,
        }
