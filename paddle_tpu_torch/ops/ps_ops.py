"""Parameter-server ops: send / recv / barriers / listen_and_serv and
the sparse-table ops.

Counterpart of ``paddle_tpu/ops/ps_ops.py``: the same 18 op types with
the same slots, attrs and RPC messages, so a trainer of either package
runs against a pserver of the other.

Reference parity: send_op.cc, recv_op.cc, send_barrier_op.cc,
fetch_barrier_op.cc; listen_and_serv_op.cc:109 RunSyncLoop (barrier ->
run optimize blocks -> barrier) and :225 RunAsyncLoop (grad name ->
block, applied on arrival); parameter_send.cc's row-sliced send.

The control plane runs on the host over ``distributed/rpc.py`` and
values cross the wire as numpy arrays.  A ``send`` copies the tensor to
the host through page-locked memory (``core/types.to_numpy``); a
``recv`` places what arrives on the executor's device, and so does
every pserver handler: the optimize blocks run on the pserver's
executor device, the card unless it was given ``CPUPlace``.  Handlers
run on the RPC server's connection threads, each block under
``torch.no_grad()`` (``RuntimeCtx.run_block``).
"""

from __future__ import annotations

import os
import tempfile
import threading

import numpy as np
import torch

from paddle_tpu_torch.core.executor import register_special_op
from paddle_tpu_torch.core.registry import REQUIRED, register_op
from paddle_tpu_torch.core.scope import SelectedRows
from paddle_tpu_torch.core.types import from_numpy, to_numpy, \
    to_torch_dtype
from paddle_tpu_torch.distributed.rpc import (global_rpc_client,
                                               make_rpc_server)


def _structural(ins, attrs, device):  # pragma: no cover
    raise RuntimeError("PS op must run via the executor (host op)")


# registry entries so append_op validates attrs + programs serialize
register_op("send", inputs=("X",), outputs=(),
            attrs={"epmap": [], "section_names": [], "sections": [],
                   "trainer_idx": -1},
            differentiable=False, host_only=True)(_structural)
register_op("recv", inputs=(), outputs=("Out",),
            attrs={"epmap": [], "section_names": [], "sections": [],
                   "trainer_idx": -1},
            differentiable=False, host_only=True)(_structural)
register_op("send_barrier", inputs=(), outputs=(),
            attrs={"endpoints": [], "peer_id": ""},
            differentiable=False, host_only=True)(_structural)
register_op("fetch_barrier", inputs=(), outputs=(),
            attrs={"endpoints": [], "peer_id": ""},
            differentiable=False, host_only=True)(_structural)
register_op("listen_and_serv", inputs=(), outputs=(),
            attrs={"endpoint": REQUIRED, "Fanin": 1, "sync_mode": True,
                   "grad_blocks": [], "lr_names": [],
                   "sparse_grad_blocks": [],
                   "dc_pairs": [],
                   "heartbeat_timeout": 10.0,
                   "barrier_timeout": 0.0},
            differentiable=False, host_only=True)(_structural)
register_op("ps_sync_init", inputs=("X",), outputs=(),
            duplicable=("X",), optional=("X",),
            attrs={"endpoints": [], "push_plan": [], "is_pusher": False},
            differentiable=False, host_only=True)(_structural)
register_op("checkpoint_notify", inputs=(), outputs=(),
            attrs={"endpoints": [], "dirname": ""},
            differentiable=False, host_only=True)(_structural)
register_op("heartbeat_start", inputs=(), outputs=(),
            attrs={"endpoints": [], "peer_id": REQUIRED,
                   "interval": 1.0},
            differentiable=False, host_only=True)(_structural)
register_op("prefetch", inputs=("Ids",), outputs=("Out",),
            attrs={"epmap": [], "table_names": [], "sections": [],
                   "padding_idx": -1, "emb_dim": REQUIRED},
            differentiable=False, host_only=True)(_structural)
register_op("send_sparse_grad", inputs=("Ids", "Grad"), outputs=(),
            attrs={"epmap": [], "section_names": [], "sections": [],
                   "padding_idx": -1},
            differentiable=False, host_only=True)(_structural)


@register_op("sparse_sgd",
             inputs=("Param", "Rows", "Grad", "LearningRate"),
             outputs=("ParamOut",), differentiable=False,
             in_place={"Param": "ParamOut"})
def sparse_sgd(ins, attrs, device):
    """Row-wise SGD on a sharded lookup table (reference
    operators/optimizers/sgd_op.h SelectedRows branch: update only the
    touched rows).  Duplicate rows accumulate, matching the SelectedRows
    sum semantics."""
    w, rows, g = ins["Param"], ins["Rows"], ins["Grad"]
    lr = ins["LearningRate"].reshape(())
    if rows.shape[0] == 0:
        return {"ParamOut": w}
    return {"ParamOut": w.index_add(0, rows.long(),
                                    (-lr * g).to(w.dtype))}


def _host(v, name):
    """A scope value as a host numpy array (a card tensor through
    page-locked memory)."""
    if isinstance(v, torch.Tensor):
        return to_numpy(v, name)
    return np.asarray(v)


def _on(device, val, name):
    """A wire value as a tensor on ``device``."""
    return from_numpy(np.asarray(val), name).to(device)


@register_special_op("heartbeat_start")
def heartbeat_start_op(op, block, scope, ctx):
    """Idempotent: spawn one HeartbeatSender daemon per (endpoint,
    peer_id); the trainer program carries this op at step 0 position so
    the first exe.run announces the trainer to every pserver's
    HeartbeatMonitor (the survivor-continue counterpart of
    listen_and_serv's effective_fanin).  RPCClient.send_complete stops
    the senders again, so completed jobs don't leak beat threads."""
    from paddle_tpu_torch.distributed.rpc import start_shared_heartbeat

    peer = op.attrs["peer_id"]
    for ep in op.attrs["endpoints"]:
        start_shared_heartbeat(ep, peer,
                               interval=float(
                                   op.attrs.get("interval", 1.0)))


def _tid(op):
    """trainer_idx attr -> int, or None when unset (-1 sentinel)."""
    tid = op.attrs.get("trainer_idx", -1)
    return None if tid is None or int(tid) < 0 else int(tid)


@register_special_op("send")
def send_op(op, block, scope, ctx):
    """Row-sliced send of a var's sections to their pservers
    (reference parameter_send.cc).  One host copy of the whole var,
    then its sections."""
    client = global_rpc_client()
    tid = _tid(op)
    name = op.inputs["X"][0]
    x = _host(scope.find_var(name).get(), name)
    for ep, sec_name, (s, e) in zip(op.attrs["epmap"],
                                    op.attrs["section_names"],
                                    op.attrs["sections"]):
        sec = x if s == 0 and e == -1 else x[s:e]
        client.send_var(ep, sec_name, np.ascontiguousarray(sec),
                        trainer_idx=tid)


@register_special_op("recv")
def recv_op(op, block, scope, ctx):
    client = global_rpc_client()
    tid = _tid(op)
    parts = []
    for ep, name, _sec in zip(op.attrs["epmap"],
                              op.attrs["section_names"],
                              op.attrs["sections"]):
        parts.append(client.get_var(ep, name, trainer_idx=tid))
    val = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
    out = op.outputs["Out"][0]
    scope.var(out).set(_on(ctx.device, val, out))


@register_special_op("send_barrier")
def send_barrier_op(op, block, scope, ctx):
    client = global_rpc_client()
    peer = op.attrs.get("peer_id") or None
    for ep in op.attrs["endpoints"]:
        client.send_barrier(ep, peer_id=peer)


@register_special_op("fetch_barrier")
def fetch_barrier_op(op, block, scope, ctx):
    client = global_rpc_client()
    peer = op.attrs.get("peer_id") or None
    for ep in op.attrs["endpoints"]:
        client.fetch_barrier(ep, peer_id=peer)


def _flat_ids(ids):
    squeeze = ids.ndim >= 2 and ids.shape[-1] == 1
    flat = (ids[..., 0] if squeeze else ids).reshape(-1).astype(np.int64)
    return squeeze, flat


@register_special_op("prefetch")
def prefetch_op(op, block, scope, ctx):
    """Distributed-lookup-table forward: split ids by table section, ask
    each owning pserver for its rows, reassemble in id order (reference
    operators/distributed/parameter_prefetch.cc:1 prefetch + split_ids +
    merge_ids)."""
    client = global_rpc_client()
    ids_name = op.inputs["Ids"][0]
    ids = _host(scope.find_var(ids_name).get(), ids_name)
    squeeze, flat = _flat_ids(ids)
    emb_dim = int(op.attrs["emb_dim"])
    out_name = op.outputs["Out"][0]
    dtype = np.dtype(block.var(out_name).dtype) \
        if block.has_var(out_name) and block.var(out_name).dtype \
        else np.dtype(np.float32)
    out = np.zeros((flat.shape[0], emb_dim), dtype)
    for ep, tname, (s, e) in zip(op.attrs["epmap"],
                                 op.attrs["table_names"],
                                 op.attrs["sections"]):
        mask = (flat >= s) & (flat < e)
        if not mask.any():
            continue
        local = flat[mask] - s
        rows = client.call(ep, "prefetch_rows",
                           (tname, np.ascontiguousarray(local)))
        out[mask] = rows
    pad = int(op.attrs["padding_idx"])
    if pad >= 0:
        out[flat == pad] = 0.0
    shape = (ids.shape[:-1] if squeeze else ids.shape) + (emb_dim,)
    scope.var(out_name).set(_on(ctx.device, out.reshape(shape), out_name))


@register_special_op("send_sparse_grad")
def send_sparse_grad_op(op, block, scope, ctx):
    """Distributed-lookup-table backward: push (rows, grad-rows) of the
    table gradient to the owning pservers (reference split_ids_op.cc +
    the SelectedRows send path of parameter_send.cc)."""
    client = global_rpc_client()
    ids_name, grad_name = op.inputs["Ids"][0], op.inputs["Grad"][0]
    ids = _host(scope.find_var(ids_name).get(), ids_name)
    grad = _host(scope.find_var(grad_name).get(), grad_name)
    _, flat = _flat_ids(ids)
    g = grad.reshape(flat.shape[0], -1)
    pad = int(op.attrs["padding_idx"])
    if pad >= 0:
        keep = flat != pad
        flat, g = flat[keep], g[keep]
    for ep, gsec, (s, e) in zip(op.attrs["epmap"],
                                op.attrs["section_names"],
                                op.attrs["sections"]):
        mask = (flat >= s) & (flat < e)
        if not mask.any():
            continue  # sync merge divides by fanin, so skipping is safe
        local = flat[mask] - s
        client.call(ep, "send_sparse",
                    (gsec, np.ascontiguousarray(local),
                     np.ascontiguousarray(g[mask])))


@register_special_op("checkpoint_notify")
def checkpoint_notify_op(op, block, scope, ctx):
    """Trainer asks every pserver to checkpoint its shards (reference
    checkpoint_notify_op.cc -> pserver checkpoint block)."""
    client = global_rpc_client()
    for ep in op.attrs["endpoints"]:
        client.call(ep, "checkpoint_notify", op.attrs["dirname"])


@register_special_op("ps_sync_init")
def ps_sync_init_op(op, block, scope, ctx):
    """Initial-parameter sync: trainer 0 pushes its initialized param
    sections to the pservers and signals init-done; other trainers wait
    (gives every trainer/pserver bit-identical initial params — the
    reference gets this by initializing on the pserver and having all
    trainers recv before step 1)."""
    client = global_rpc_client()
    if op.attrs["is_pusher"]:
        for var_name, ep, sec_name, s, e in op.attrs["push_plan"]:
            x = _host(scope.find_var(var_name).get(), var_name)
            sec = x if s == 0 and e == -1 else x[s:e]
            client.send_var(ep, sec_name, np.ascontiguousarray(sec))
        for ep in op.attrs["endpoints"]:
            client.call(ep, "init_done")
    else:
        for ep in op.attrs["endpoints"]:
            client.call(ep, "init_wait")


@register_special_op("listen_and_serv")
def listen_and_serv_op(op, block, scope, ctx):
    """Pserver event loop.  Blocks until every trainer sent Complete.

    sync mode  (reference RunSyncLoop,  listen_and_serv_op.cc:109):
      accumulate grads per name; on the send barrier, one handler thread
      averages each grad's sections and runs its optimize block; the
      fetch barrier closes the round.  One trainer's grad is used as it
      arrived (no arithmetic), so a one-trainer cluster takes the local
      run's steps bit for bit.
    async mode (reference RunAsyncLoop, :225): each arriving grad runs
      its block immediately under the update lock (Hogwild-ish, the
      Downpour staleness model).
    """
    attrs = op.attrs
    device = ctx.device
    fanin = int(attrs["Fanin"])
    sync = bool(attrs["sync_mode"])
    grad_blocks = [(g, int(b)) for g, b in attrs["grad_blocks"]]
    grad_block_map = dict(grad_blocks)
    sparse_blocks = [(g, int(b))
                     for g, b in attrs.get("sparse_grad_blocks", [])]
    sparse_block_map = dict(sparse_blocks)

    server = make_rpc_server(attrs["endpoint"])
    buffers: dict = {}
    sparse_buffers: dict = {}
    lock = threading.Lock()
    stop = threading.Event()
    init_evt = threading.Event()
    ncomplete = [0]

    def _set(name, val):
        scope.var(name).set(_on(device, val, name))

    # DC-ASGD (reference _append_dc_asgd_ops + RequestGetHandler's
    # dc_asgd branch): per-trainer param backups, snapshotted when the
    # trainer pulls; primed lazily so a pre-first-pull gradient gets
    # zero correction instead of w - 0
    dc_pairs = {g: p for g, p in attrs.get("dc_pairs", [])}
    dc_secs = set(dc_pairs.values())
    dc_primed: set = set()

    def _dc_prime(sec, tid):
        if (sec, tid) in dc_primed:
            return
        pv = scope.find_var(sec)
        if pv is not None and pv.get() is not None:
            scope.var(f"{sec}.bak.{tid}").set(pv.get().clone())
            # marked primed only on a REAL snapshot: an early grad
            # before the init push lands must retry, or the backup
            # stays zero and g + g*g*(w - 0) overcorrects forever
            dc_primed.add((sec, tid))

    def _apply_sparse(gsec, rows, vals):
        _set(gsec + ".rows", rows)
        _set(gsec + ".values", vals)
        ctx.run_block(sparse_block_map[gsec], scope)

    def on_send_var(payload):
        name, val = payload[0], payload[1]
        tid = payload[2] if len(payload) > 2 else None
        peer = None if tid is None else f"trainer{int(tid)}"
        with lock:
            if sync and name in grad_block_map:
                # tagged with the sender so a peer fenced between push
                # and merge can be excluded from the round
                buffers.setdefault(name, []).append((peer, val))
            else:
                _set(name, val)
                if name in grad_block_map:   # async: apply on arrival
                    if name in dc_pairs:
                        k = int(tid) if tid is not None else 0
                        _dc_prime(dc_pairs[name], k)
                        _set("@TRAINER_ID@", np.asarray([k], np.int32))
                    ctx.run_block(grad_block_map[name], scope)

    def _fenced_peer(peer):
        # a fenced-but-still-alive trainer must not participate: it was
        # excluded from effective_fanin, so letting it join would
        # release barriers early and desync the true survivors
        if peer is None:
            return False
        with live_lock:
            return str(peer) in fenced

    def _alive(peer_str):
        with live_lock:
            return peer_str not in fenced

    def _reject_fenced(peer):
        if _fenced_peer(peer):
            # loud: a zombie trainer must crash, not free-run
            # unsynchronized while its stale grads contaminate rounds
            raise RuntimeError(
                f"trainer '{peer}' was declared dead (missed "
                "heartbeats) and is fenced from this cluster")

    # barrier deadline: 0.0 -> env PADDLE_TPU_BARRIER_TIMEOUT (600s
    # default) — a wedged round raises a BarrierTimeoutError naming the
    # barrier + waiters at every party instead of hanging the job
    barrier_timeout = float(attrs.get("barrier_timeout", 0.0)) or None

    def on_send_barrier(peer):
        if not sync:
            return
        _reject_fenced(peer)
        lead = server.barrier_dynamic("send", effective_fanin,
                                      peer=peer, alive_fn=_alive,
                                      timeout=barrier_timeout)
        if lead == 0:
            with lock:
                for gname, bidx in grad_blocks:
                    vals = buffers.pop(gname, None)
                    if vals:  # drop entries a fenced peer pushed
                        vals = [v for p, v in vals
                                if p is None or _alive(p)]
                    if not vals:
                        continue
                    merged = vals[0] if len(vals) == 1 else \
                        np.mean(np.stack(vals), axis=0)
                    _set(gname, merged)
                    ctx.run_block(bidx, scope)
                for gsec, _bidx in sparse_blocks:
                    parts = sparse_buffers.pop(gsec, None)
                    if not parts:
                        continue
                    rows = np.concatenate([r for r, _ in parts])
                    # mean over trainers: live fanin, except a trainer
                    # that pushed THEN died still counts for this round
                    # (trainers with no ids skip the push, so a bare
                    # len(parts) would over-scale)
                    vals2 = np.concatenate([v for _, v in parts]) \
                        / float(max(len(parts), effective_fanin()))
                    if rows.size:
                        _apply_sparse(gsec, rows, vals2)
        server.barrier_dynamic("send_done", effective_fanin,
                               peer=peer, alive_fn=_alive,
                               timeout=barrier_timeout)

    def on_get_var(payload):
        name, tid = (payload, None) if isinstance(payload, str) \
            else (payload[0], payload[1])
        with lock:
            var = scope.find_var(name)
            if var is None or var.get() is None:
                raise KeyError(f"pserver has no var '{name}'")
            val = _host(var.get(), name)
            if tid is not None and name in dc_secs:
                # the pull snapshot this trainer's future delayed
                # grads will be corrected against
                scope.var(f"{name}.bak.{int(tid)}").set(
                    var.get().clone())
                dc_primed.add((name, int(tid)))
            return val

    def on_prefetch_rows(payload):
        """Lookup rows of a table shard (reference: the pserver-side
        lookup block, distribute_transpiler.py:1583).  Rows are gathered
        on the device before the host copy — never materialize the whole
        shard per RPC."""
        tname, rows = payload
        with lock:
            var = scope.find_var(tname)
            if var is None or var.get() is None:
                raise KeyError(f"pserver has no table shard '{tname}'")
            w = var.get()
            picked = torch.index_select(
                w, 0, torch.from_numpy(rows.astype(np.int64)).to(w.device))
        return np.ascontiguousarray(_host(picked, tname))

    def on_send_sparse(payload):
        gsec, rows, vals = payload
        with lock:
            if sync:
                sparse_buffers.setdefault(gsec, []).append((rows, vals))
            elif rows.size:
                _apply_sparse(gsec, rows, vals)

    def on_fetch_barrier(peer):
        if not sync:
            return
        _reject_fenced(peer)
        server.barrier_dynamic("fetch", effective_fanin, peer=peer,
                               alive_fn=_alive,
                               timeout=barrier_timeout)

    def on_complete(peer):
        if peer is not None:
            with live_lock:
                completed.add(str(peer))
                fenced.discard(str(peer))
            hb_monitor.forget(peer)  # retired, not dead
        with lock:
            ncomplete[0] += 1
            if ncomplete[0] >= outstanding_completions():
                stop.set()

    def on_reregister(peer):
        """Elastic resume: a relaunched trainer re-joins under its old
        peer id — un-fence it (its crash got it declared dead),
        un-retire it, and reset its liveness clock so effective_fanin
        counts it again.  Idempotent and retry-safe; returns the fanin
        the caller rejoins."""
        if peer is not None:
            with live_lock:
                fenced.discard(str(peer))
                completed.discard(str(peer))
            hb_monitor.forget(peer)
        return effective_fanin()

    def on_init_done(_):
        init_evt.set()

    def on_init_wait(_):
        if not init_evt.wait(timeout=120.0):
            raise TimeoutError(
                "init_wait: trainer 0 never pushed initial params "
                "(is it up? did ps_sync_init run?)")

    def on_profile(payload):
        """Remote profiling trigger (reference
        send_recv.proto.in:81 VariableMessage.profile: a trainer flips
        profiling on across the cluster; the server dumps a profile
        when it flips back off).  payload: "start" | ("stop", path).
        The port's profiler records the host spans and, through
        torch.profiler, the device's kernels (the card's on a card
        pserver); the stop writes them as one chrome trace."""
        from paddle_tpu_torch import profiler as _prof

        if payload == "start" or payload == 1:
            _prof.start_profiler(
                "All" if device.type == "cuda" else "CPU",
                tracer_option="Default")
            return "profiling"
        cmd, path = payload if isinstance(payload, tuple) else \
            (payload, None)
        if cmd in ("stop", 2):
            # the reference's /tmp/profile_ps_<endpoint> convention, in
            # the temporary directory
            path = path or os.path.join(
                tempfile.gettempdir(),
                "profile_ps_%s" % attrs["endpoint"].replace(":", "_"))
            _prof.stop_profiler(sorted_key="total", profile_path=path)
            return path
        raise ValueError(f"unknown profile command {payload!r}")

    def _ckpt_step_dir(dirname, step):
        ep_san = attrs["endpoint"].replace(":", "_").replace("/", "_")
        return os.path.join(str(dirname), "ps_%s" % ep_san,
                            "step_%d" % int(step))

    def on_checkpoint(payload):
        """Snapshot the WHOLE pserver scope — param sections AND the
        optimizer accumulators the optimize blocks created (momentum
        velocities, Adam moments) — so a resume is exact under stateful
        pserver optimizers.  payload: a plain dirname (flat snapshot)
        or (dirname, step) — then the snapshot lands in a per-endpoint
        per-step subdir, written to a tmp dir and atomically renamed so
        a crash mid-snapshot can never leave a torn step dir a later
        restore would half-load.  A MANIFEST.json maps files back to
        var names ('/' is mangled in filenames)."""
        import json as _json
        import shutil

        stepped = isinstance(payload, (tuple, list))
        dirname = _ckpt_step_dir(*payload) if stepped else str(payload)
        # per-thread tmp suffix: a transparently retried notify must
        # never race the original onto the same staging dir
        outdir = "%s.tmp%d" % (dirname, threading.get_ident()) \
            if stepped else dirname
        os.makedirs(outdir, exist_ok=True)
        manifest = {}
        with lock:
            for name, var in scope.vars.items():
                v = var.get()
                if v is not None and hasattr(v, "dtype"):
                    fname = name.replace("/", "_") + ".npy"
                    np.save(os.path.join(outdir, fname), _host(v, name))
                    manifest[fname] = name
        with open(os.path.join(outdir, "MANIFEST.json"), "w") as f:
            _json.dump(manifest, f)
        if stepped:
            if os.path.isdir(dirname):
                shutil.rmtree(dirname)
            os.replace(outdir, dirname)
        return len(manifest)

    def on_checkpoint_restore(payload):
        """Load a (dirname, step) snapshot back into the scope: params
        roll back to the checkpoint cut AND the optimizer state comes
        with them.  Returns the number of vars restored; 0 when no such
        snapshot exists (the caller falls back to the params-only
        push).  Idempotent."""
        import json as _json

        dirname = _ckpt_step_dir(*payload)
        man_path = os.path.join(dirname, "MANIFEST.json")
        if not os.path.isdir(dirname) or not os.path.exists(man_path):
            return 0
        with open(man_path) as f:
            manifest = _json.load(f)
        n = 0
        with lock:
            for fname, name in manifest.items():
                path = os.path.join(dirname, fname)
                if not os.path.exists(path):
                    continue
                _set(name, np.load(path))
                n += 1
        return n

    # elastic liveness: trainers heartbeat; sync barriers re-count to
    # the live non-completed trainer set so survivors CONTINUE when a
    # trainer dies mid-step
    from paddle_tpu_torch.distributed.rpc import HeartbeatMonitor

    hb_monitor = HeartbeatMonitor(
        timeout=float(attrs.get("heartbeat_timeout", 10.0)))
    fenced: set = set()     # once declared dead, STAYS out: a peer
    completed: set = set()  # resuming beats must not desync barriers
    live_lock = threading.Lock()

    def effective_fanin():
        # peers that ever heartbeat and then went silent are fenced
        # permanently; completed peers are retired cleanly (forget());
        # with no heartbeats configured this degrades to fixed fanin
        with live_lock:
            fenced.update(hb_monitor.dead_peers())
            return max(1, fanin - len(fenced | completed))

    def outstanding_completions():
        with live_lock:
            fenced.update(hb_monitor.dead_peers())
            return fanin - len(fenced)
    server.register_handler("heartbeat", hb_monitor.beat)
    server.register_handler("live_trainers",
                            lambda _: hb_monitor.live_peers())
    server.register_handler("dead_trainers",
                            lambda _: hb_monitor.dead_peers())
    server.register_handler("send_var", on_send_var)
    server.register_handler("send_barrier", on_send_barrier)
    server.register_handler("get_var", on_get_var)
    server.register_handler("prefetch_rows", on_prefetch_rows)
    server.register_handler("send_sparse", on_send_sparse)
    server.register_handler("fetch_barrier", on_fetch_barrier)
    server.register_handler("complete", on_complete)
    server.register_handler("reregister", on_reregister)
    server.register_handler("init_done", on_init_done)
    server.register_handler("init_wait", on_init_wait)
    server.register_handler("checkpoint_notify", on_checkpoint)
    server.register_handler("checkpoint_restore", on_checkpoint_restore)
    server.register_handler("profile", on_profile)

    # observability surface: a 'varz' RPC returning the process metrics
    # snapshot (wire-encodable dict; the fleet collector polls it), and
    # — when the metrics_port attr / PADDLE_TPU_METRICS_PORT is set —
    # the /metrics + /varz HTTP endpoint mounted for scrapers
    from paddle_tpu_torch.observability import metrics as _obs_metrics
    from paddle_tpu_torch.observability.export import (
        MetricsHTTPServer, metrics_port_from_env)

    server.register_handler(
        "varz", lambda _=None: _obs_metrics.registry().snapshot())
    mport = int(attrs.get("metrics_port", -1))
    if mport < 0:
        mport = metrics_port_from_env(-1)
    metrics_http = None
    if mport is not None and mport >= 0:
        try:
            metrics_http = MetricsHTTPServer(port=mport).start()
        except OSError:
            metrics_http = None   # port taken: a scrape endpoint is
            #                       an optimization, never a crash
    server.start()
    try:
        while not stop.wait(timeout=0.25):
            # trainers dying must not wedge shutdown: completion only
            # required of peers that are neither fenced nor completed
            # (covers the every-trainer-crashed case: 0 outstanding)
            with lock:
                if ncomplete[0] >= outstanding_completions():
                    stop.set()
    finally:
        if metrics_http is not None:
            metrics_http.stop()
        server.stop()


@register_op("split_ids", inputs=("Ids",), outputs=("Out",),
             duplicable=("Ids", "Out"),
             attrs={"sections": []},
             differentiable=False)
def split_ids_op_compute(ins, attrs, device):
    """split_ids_op.cc re-spec: partition a flat id vector by contiguous
    row sections [[s,e],...] (the reference hashes by id % n_shard; our
    tables shard by contiguous ranges like slice_variable).  Fixed-shape
    outputs: each section output has the full length with non-members
    masked to -1 (LoD-free re-spec; the PS prefetch handler compacts)."""
    ids = ins["Ids"][0].reshape(-1)
    outs = []
    for s, e in attrs["sections"]:
        member = (ids >= s) & (ids < e)
        outs.append(torch.where(member, ids, torch.full_like(ids, -1)))
    return {"Out": outs}


@register_op("merge_ids", inputs=("Ids", "Rows", "X"), outputs=("Out",),
             duplicable=("Ids", "Rows", "X"),
             attrs={}, differentiable=False)
def merge_ids_op_compute(ins, attrs, device):
    """merge_ids_op.cc re-spec: scatter per-section embedding rows back
    into the original id order.  Ids: original flat ids [N]; Rows: the
    masked per-section id vectors from split_ids ([N] each, -1 = not
    mine); X: per-section embedding results [N, D] (rows for masked-out
    ids are ignored)."""
    ids = ins["Ids"][0].reshape(-1)
    x0 = ins["X"][0]
    out = torch.zeros((ids.shape[0], x0.shape[-1]), dtype=x0.dtype,
                      device=x0.device)
    for rows, x in zip(ins["Rows"], ins["X"]):
        member = rows.reshape(-1) >= 0
        out = torch.where(member[:, None], x, out)
    return {"Out": out}


@register_op("split_byref", inputs=("X",), outputs=("Out",),
             duplicable=("Out",),
             attrs={"sections": []}, differentiable=False)
def split_byref_op_compute(ins, attrs, device):
    """split_byref_op.cc: split rows into contiguous sections (the
    by-ref aliasing is a buffer concern; functionally a row split)."""
    x = ins["X"]
    outs, start = [], 0
    for n in attrs["sections"]:
        outs.append(x[start:start + int(n)])
        start += int(n)
    return {"Out": outs}


@register_op("split_selected_rows", inputs=("X",), outputs=("Out",),
             duplicable=("Out",),
             attrs={"height_sections": []}, differentiable=False,
             host_only=True)
def _split_selected_rows_structural(ins, attrs, device):
    raise RuntimeError("split_selected_rows runs via the executor")


@register_special_op("split_selected_rows")
def split_selected_rows_op(op, block, scope, ctx):
    """split_selected_rows_op.cc: partition a SelectedRows by row
    ranges."""
    x = scope.find_var(op.inputs["X"][0]).get()
    secs = op.attrs["height_sections"]
    bounds = np.cumsum([0] + [int(s) for s in secs])
    rows = torch.as_tensor(x.rows)
    vals = torch.as_tensor(x.values)
    for i, name in enumerate(op.outputs["Out"]):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        m = (rows >= lo) & (rows < hi)
        scope.var(name).set(SelectedRows(
            rows=(rows[m] - lo).to(ctx.device),
            values=vals[m.to(vals.device)].to(ctx.device),
            height=hi - lo))


@register_op("lookup_sparse_table", inputs=("W", "Ids"),
             outputs=("Out",),
             attrs={"padding_idx": -1, "auto_grown_table": True},
             differentiable=False)
def lookup_sparse_table(ins, attrs, device):
    """lookup_sparse_table_op.cc: the pserver-side table lookup block's
    op — rows gathered from the local shard (auto-grow is a no-op in
    the dense-shard re-spec; unseen ids read zeros via clipping)."""
    w, ids = ins["W"], ins["Ids"]
    flat = ids.reshape(-1).long()
    valid = (flat >= 0) & (flat < w.shape[0])
    picked = torch.index_select(w, 0, torch.clamp(flat, 0, w.shape[0] - 1))
    return {"Out": torch.where(valid[:, None], picked,
                               torch.zeros((), dtype=w.dtype,
                                           device=w.device))}


@register_op("fake_init", inputs=(), outputs=("Out",),
             attrs={"shape": REQUIRED, "dtype": "float32"},
             differentiable=False, host_only=True)
def _fake_init_structural(ins, attrs, device):
    raise RuntimeError("fake_init runs via the executor")


@register_special_op("fake_init")
def fake_init_op(op, block, scope, ctx):
    """fake_init_op.cc: mark a trainer-side var 'initialized' without
    real content (its value lives on the pserver); zeros stand in."""
    shape = [int(s) for s in op.attrs["shape"]]
    scope.var(op.outputs["Out"][0]).set(
        torch.zeros(shape, dtype=to_torch_dtype(op.attrs["dtype"]),
                    device=ctx.device))


@register_op("ref_by_trainer_id", inputs=("X", "TrainerId"),
             outputs=("Out",), duplicable=("X",),
             differentiable=False)
def ref_by_trainer_id(ins, attrs, device):
    """distributed_ops/ref_by_trainer_id_op.cc: Out = X[trainer_id] —
    pserver DC-ASGD blocks pick their per-trainer state this way.  The
    id is read on the host and clipped to the list, as the JAX
    package's static-rank select clips it."""
    xs = ins["X"]
    tid = int(ins["TrainerId"].reshape(-1)[0])
    return {"Out": xs[min(max(tid, 0), len(xs) - 1)]}
