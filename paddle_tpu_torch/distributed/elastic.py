"""Crash-resume elasticity for (PS-)training loops.

Counterpart of ``paddle_tpu/distributed/elastic.py``, the same contract
over the port's ``contrib.checkpoint.AsyncCheckpointer`` (a format of
its own) and RPC client.  Checkpoint-based elastic training in the
Varuna / Elastic-Horovod style: the train loop is wrapped so that (a)
the persistable state is checkpointed asynchronously every
`save_every` steps, and (b) a relaunched trainer
process resumes from the latest checkpoint, re-registers with the
pservers (un-fencing its peer id and restarting heartbeats), and —
when a transpiler is given — rolls the pserver shards back to the
checkpointed params so the whole cluster replays from a consistent
cut.  With step-keyed data, the post-crash trajectory is bit-identical
to the uninterrupted run (tests/test_torch_elastic.py holds it).

Resume contract:
  - checkpoint step S == "state after completing steps [0, S)"; resume
    returns S and the loop continues at step index S;
  - the caller must run its startup program FIRST (restore needs an
    initialized scope template), and the resumed process must come up
    within the pservers' heartbeat_timeout of the crash OR use a
    timeout generous enough to cover relaunch (a fenced peer is
    un-fenced by the reregister RPC, but a pserver whose every trainer
    is fenced shuts itself down);
  - with optimizer state living on the pservers (momentum/Adam
    shards), pass ``ps_state_dir``: every trainer checkpoint then also
    triggers a ``checkpoint_notify`` snapshot of each pserver's WHOLE
    scope (param sections + optimizer accumulators) at the same step
    cut, and resume() rolls the shards back via ``checkpoint_restore``
    — exact resume under stateful pserver optimizers.  In sync mode
    the cut is consistent for free: the pserver can't apply the next
    round until EVERY trainer reaches the send barrier, and the
    notifying trainer hasn't.  Without ``ps_state_dir`` (or when the
    snapshot is missing, e.g. a pserver relaunched on a fresh disk)
    resume falls back to the params-only section push — exact for
    SGD-style stateless-pserver setups only.

    ck = AsyncCheckpointer(dirname)
    el = ElasticTrainer(ck, transpiler=t, save_every=5)
    start = el.resume()            # 0 on a fresh start
    for step in range(start, n_steps):
        ... exe.run(...) ...
        el.step_done(step)
    el.finish()
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.observability import flight_recorder as _flight
from paddle_tpu_torch.observability import metrics as _obs_metrics

__all__ = ["ElasticTrainer"]

_M_CKPT_SECONDS = _obs_metrics.histogram(
    "paddle_tpu_elastic_checkpoint_seconds",
    "wall time of the synchronous part of each elastic checkpoint "
    "cut (async submit + pserver snapshot notify)")
_M_EVENTS = _obs_metrics.counter(
    "paddle_tpu_elastic_events_total",
    "elastic-trainer transitions (checkpoints / resumes), by event")


class ElasticTrainer:
    def __init__(self, checkpointer, transpiler=None, endpoints=(),
                 peer_id=None, save_every=10, program=None, scope=None,
                 wait_each_save=False, ps_state_dir=None):
        """checkpointer: contrib.checkpoint.AsyncCheckpointer.
        transpiler: a transpiled DistributeTranspiler — supplies the
        pserver endpoints, the peer id, and the section plan for the
        rollback push; endpoints/peer_id override or stand in for it
        (endpoints may be empty for single-process elasticity).
        program/scope: forwarded to the checkpointer (defaults:
        default_main_program / global scope).  wait_each_save: block
        until each checkpoint is durable before continuing — slower,
        but a crash can then lose at most save_every steps (async
        saves in flight at crash time are not durable).
        ps_state_dir: directory (shared or per-host) for pserver-side
        scope snapshots — each trainer checkpoint also sends a
        ``checkpoint_notify`` so the pservers snapshot their params AND
        optimizer accumulators at the same step cut, and resume() rolls
        them back via ``checkpoint_restore`` (exact resume under
        momentum/Adam pserver shards; see the resume contract above).
        Only trainer 0 should pass it in multi-trainer setups (one
        snapshot per cut suffices)."""
        self._ck = checkpointer
        self._t = transpiler
        self._endpoints = list(endpoints) or (
            list(transpiler.endpoints) if transpiler is not None else [])
        if peer_id is None and transpiler is not None:
            peer_id = f"trainer{transpiler.trainer_id}"
        self._peer_id = peer_id
        self._save_every = int(save_every)
        self._program = program
        self._scope = scope
        self._wait_each_save = bool(wait_each_save)
        self._ps_dir = None if ps_state_dir is None else str(ps_state_dir)

    # ------------------------------------------------------------ resume
    def resume(self):
        """Restore the latest checkpoint (if any) into the scope,
        re-register with every pserver, and — when a transpiler is
        available — push the restored param sections back so the
        pserver shards match the checkpoint cut.  Returns the step
        index to continue from (0 when no checkpoint exists)."""
        step = self._ck.latest_step()
        if step is not None:
            self._ck.restore(step, program=self._program,
                             scope=self._scope)
        self.reregister()
        if step is not None:
            # exact path first: roll every pserver's scope (params +
            # optimizer accumulators) back to the same step cut; only
            # when a shard has no snapshot fall back to the params-only
            # section push (exact for stateless pserver optimizers)
            if not self._restore_ps_state(int(step)) and \
                    self._t is not None:
                self._push_restored_params()
        _M_EVENTS.inc(event="resumes")
        _flight.record("elastic", "resume",
                       step=0 if step is None else int(step),
                       peer=self._peer_id)
        return 0 if step is None else int(step)

    def _restore_ps_state(self, step):
        """checkpoint_restore on every pserver; True iff EVERY endpoint
        restored a non-empty snapshot for `step` (partial restores fall
        back to the push so params at least stay consistent)."""
        if not self._ps_dir or not self._endpoints:
            return False
        from paddle_tpu_torch.distributed.rpc import global_rpc_client

        client = global_rpc_client()
        ok = True
        for ep in self._endpoints:
            try:
                n = client.call(ep, "checkpoint_restore",
                                (self._ps_dir, int(step)))
            except Exception:
                n = 0
            ok = ok and bool(n)
        return ok

    def _notify_ps_snapshot(self, step):
        """Ask every pserver to snapshot its scope at this step cut
        (sync mode makes the cut consistent: the next round can't apply
        until this trainer reaches the send barrier).  Best-effort — a
        failed snapshot degrades that step's resume to the params-only
        push, it must not kill training."""
        if not self._ps_dir or not self._endpoints:
            return
        from paddle_tpu_torch.distributed.rpc import global_rpc_client

        client = global_rpc_client()
        for ep in self._endpoints:
            try:
                client.call(ep, "checkpoint_notify",
                            (self._ps_dir, int(step)))
            except Exception:
                pass

    def reregister(self):
        """Announce this trainer to the pservers again: un-fence the
        peer id (a crashed trainer was declared dead by the heartbeat
        monitor) and restart the shared heartbeat senders.  Idempotent
        and retry-safe."""
        if not self._endpoints:
            return
        from paddle_tpu_torch.distributed.rpc import (global_rpc_client,
                                                start_shared_heartbeat)

        client = global_rpc_client()
        for ep in self._endpoints:
            client.call(ep, "reregister", self._peer_id)
            if self._peer_id is not None:
                start_shared_heartbeat(ep, self._peer_id)

    def _push_restored_params(self):
        """Roll the pserver shards back to the restored params (the
        same section plan ps_sync_init seeds them with): every peer
        then replays from one consistent cut instead of mixing a
        step-S trainer with step-(S+k) shards."""
        from paddle_tpu_torch.core.scope import global_scope
        from paddle_tpu_torch.core.types import to_numpy
        from paddle_tpu_torch.distributed.rpc import global_rpc_client

        scope = self._scope or global_scope()
        client = global_rpc_client()
        t = self._t
        for pname, plan in t.param_plan.items():
            var = scope.find_var(pname)
            if var is None or var.get() is None:
                continue
            x = to_numpy(var.get(), pname)
            for i, sec, s, e in plan:
                part = x if (s == 0 and e == -1) else x[s:e]
                client.send_var(t.endpoints[i], sec,
                                np.ascontiguousarray(part))

    # ------------------------------------------------------------- loop
    def step_done(self, step):
        """Call after completing step index `step`; checkpoints
        (asynchronously) every save_every steps."""
        if self._save_every > 0 and (int(step) + 1) % self._save_every == 0:
            import time

            t0 = time.perf_counter()
            self._ck.save(int(step) + 1, program=self._program,
                          scope=self._scope)
            self._notify_ps_snapshot(int(step) + 1)
            if self._wait_each_save:
                self._ck.wait()
            _M_CKPT_SECONDS.observe(time.perf_counter() - t0)
            _M_EVENTS.inc(event="checkpoints")
            _flight.record("elastic", "checkpoint",
                           step=int(step) + 1, peer=self._peer_id)

    def run(self, n_steps, step_fn, start_step=None):
        """Convenience loop: resume, then step_fn(step) for each
        remaining step with periodic checkpoints; returns the list of
        step_fn results (steps actually run this incarnation)."""
        start = self.resume() if start_step is None else int(start_step)
        results = []
        for step in range(start, int(n_steps)):
            results.append(step_fn(step))
            self.step_done(step)
        self.finish()
        return results

    def finish(self):
        """Barrier on outstanding async checkpoint writes."""
        self._ck.wait()
