"""Multi-tenant model fleet: zero-downtime rolling rollout and the
SLO-actuated autoscaler.

Counterpart of ``paddle_tpu/serving/fleet.py``.  Two controllers over
the serving tier:

``RolloutController``
    Swaps a served model onto a registry version REPLICA BY REPLICA
    through the per-replica drain contract (ReplicaPool.
    swap_predictor): the new version prewarms off the serving path
    first (registry.ModelVersion.prewarm: every bucket warmed up and
    captured), each replica quiesces (its in-flight batch delivers),
    hot-swaps in place (inference.Predictor.swap_program — the
    predictor OBJECT survives, so validators and replicas need no
    re-wiring), and resumes — while the other replicas keep serving.
    Zero requests are dropped (the exactly-once request-id accounting
    holds through the whole swap).  A prewarm failure surfaces the
    typed PrewarmFailedError with ZERO replicas touched; the SLO
    burn-rate signal (observability.slo) firing mid-rollout triggers
    automatic ROLLBACK, restoring the exact old program fingerprint on
    every swapped replica (asserted via core.compiler.
    program_fingerprint).

``SLOAutoscaler``
    Actuates ReplicaPool size from the same burn-rate signal.
    Sustained burn (``up_consecutive`` evaluations with both windows
    >= ``burn_up``) scales up; a sustained quiet signal (both windows
    <= ``burn_clear`` for ``down_consecutive`` evaluations) scales
    down THROUGH GRACEFUL DRAIN (remove_replica quiesces first — every
    in-flight request is answered).  Hysteresis = the burn_up /
    burn_clear gap + per-direction consecutive-evaluation streaks +
    a post-action ``cooldown_s``, so an oscillating load cannot flap
    the fleet.  ``min_replicas``/``max_replicas`` clamp hard.

Every transition records a flight-recorder event (category ``fleet``)
and rides ``paddle_tpu_fleet_events_total`` / the
``paddle_tpu_fleet_replicas`` gauge, so a post-mortem dump narrates
rollouts and scale decisions next to kills and requeues.
"""

from __future__ import annotations

import threading
import time

from paddle_tpu_torch.observability import flight_recorder as _flight
from paddle_tpu_torch.observability import metrics as _obs_metrics
from paddle_tpu_torch.serving.admission import ServingError
from paddle_tpu_torch.serving.registry import PrewarmFailedError

__all__ = ["RolloutError", "RolloutResult", "RolloutController",
           "SLOAutoscaler"]

_M_FLEET = _obs_metrics.counter(
    "paddle_tpu_fleet_events_total",
    "fleet-controller transitions (rollout_started / replica_swapped "
    "/ rollout_converged / rollout_rolled_back / scale_up / "
    "scale_down), by event")
_G_REPLICAS = _obs_metrics.gauge(
    "paddle_tpu_fleet_replicas",
    "live replicas under fleet control (last controller written wins)")
_G_VERSION = _obs_metrics.gauge(
    "paddle_tpu_fleet_model_version",
    "registry version number currently serving, by model",
    max_series=64)


class RolloutError(ServingError):
    """A rolling version swap failed in a way that was NOT cleanly
    rolled back (e.g. a replica refused to quiesce AND rollback also
    failed) — the fleet needs operator attention."""

    code = "rollout"


class RolloutResult:
    """Outcome of one rolling swap."""

    __slots__ = ("status", "model", "from_fingerprints",
                 "to_version", "swapped", "rolled_back", "reason",
                 "wall_s")

    def __init__(self, status, model, to_version, swapped,
                 rolled_back=0, reason="", wall_s=0.0,
                 from_fingerprints=None):
        self.status = status          # "converged" | "rolled_back"
        self.model = model
        self.to_version = to_version  # ModelVersion
        self.swapped = int(swapped)
        self.rolled_back = int(rolled_back)
        self.reason = reason
        self.wall_s = float(wall_s)
        self.from_fingerprints = from_fingerprints or {}

    @property
    def converged(self):
        return self.status == "converged"

    def to_dict(self):
        return {"status": self.status, "model": self.model,
                "to_version": self.to_version.version,
                "to_fingerprint": str(self.to_version.fingerprint),
                "swapped": self.swapped,
                "rolled_back": self.rolled_back,
                "reason": self.reason,
                "wall_s": round(self.wall_s, 3)}


class RolloutController:
    """Rolling version swaps of an InferenceServer's replica pool
    against a ModelRegistry.

    ``monitor`` is an observability.slo.SLOMonitor (or anything with
    ``observe()`` + ``firing()``); while set, the watch SLOs firing
    mid-rollout triggers automatic rollback.  ``bake_s`` holds between
    replica swaps with the monitor polled, so a bad version burns
    visibly BEFORE it owns the whole fleet."""

    def __init__(self, server, registry, monitor=None,
                 watch_slos=None, bake_s=0.0, poll_interval_s=0.02,
                 swap_timeout_s=10.0):
        self.server = server
        self.registry = registry
        self.monitor = monitor
        self.watch_slos = None if watch_slos is None \
            else set(watch_slos)
        self.bake_s = float(bake_s)
        self.poll_interval_s = float(poll_interval_s)
        self.swap_timeout_s = float(swap_timeout_s)
        self.state = "idle"
        self.history: list = []
        self._lock = threading.Lock()

    # -- burn signal --------------------------------------------------------
    def _burn_firing(self):
        """Watch-SLO alert names currently firing (empty = healthy)."""
        if self.monitor is None:
            return []
        try:
            self.monitor.observe()
        except Exception:
            pass
        firing = list(self.monitor.firing())
        if self.watch_slos is not None:
            firing = [n for n in firing if n in self.watch_slos]
        return firing

    def _bake(self):
        """Hold between swaps, polling the burn signal; returns the
        firing list the moment it trips (or [] after a clean bake)."""
        deadline = time.monotonic() + self.bake_s
        while True:
            firing = self._burn_firing()
            if firing or time.monotonic() >= deadline:
                return firing
            time.sleep(self.poll_interval_s)

    # -- the rollout --------------------------------------------------------
    def rollout(self, name, version=None):
        """Roll every replica onto registry version ``version`` of
        ``name`` (default: latest).  Returns a RolloutResult — status
        ``converged`` (the whole fleet runs the new version) or
        ``rolled_back`` (the burn signal fired mid-rollout and every
        swapped replica was restored to its EXACT prior program
        fingerprint).  Raises the typed PrewarmFailedError before any
        replica is touched when the new version cannot load/compile,
        and RolloutError when a failed rollout could not be cleanly
        rolled back."""
        target = self.registry.get(name, version)
        pool = self.server.pool
        t0 = time.monotonic()
        with self._lock:
            if self.state not in ("idle", "converged", "rolled_back"):
                raise RolloutError(
                    f"rollout already in progress (state={self.state})")
            self.state = "prewarming"
        _M_FLEET.inc(event="rollout_started")
        _flight.record("fleet", "rollout_started", model=str(name),
                       version=target.version,
                       fingerprint=str(target.fingerprint))
        # 1. prewarm the new version OFF the serving path: one fresh
        # predictor per replica (private scope, like the factory),
        # every bucket captured before any traffic.  A
        # failure here surfaces typed with ZERO replicas touched.
        try:
            indices = [r.index for r in pool.replicas]
            warmed = {i: target.prewarm(
                buckets=self.server.config.buckets)
                for i in indices}
        except PrewarmFailedError:
            with self._lock:
                self.state = "idle"
            _M_FLEET.inc(event="rollout_prewarm_failed")
            _flight.record("fleet", "rollout_prewarm_failed",
                           model=str(name), version=target.version)
            raise
        # convergence is judged on the SERVING fingerprint (the
        # program AFTER the predictor's load-time ir_optim passes —
        # what a replica actually reports, one value for every load of
        # the version), recorded by prewarm; the registry's serialized
        # fingerprint only keys dedupe
        target_fp = target.serving_fingerprint
        # 2. swap replica by replica through the per-replica drain;
        # the burn signal is checked after every swap (+ bake hold)
        self.state = "swapping"
        swapped: list = []   # (index, prior_state, prior_fp, prior_version)
        reason = ""
        for idx in indices:
            try:
                rep = pool.replica(idx)
            except KeyError:
                continue     # scaled away mid-rollout: nothing to swap
            prior_fp = rep.predictor.program_fingerprint()
            if prior_fp == target_fp:
                continue     # already on the target (relaunch etc.)
            try:
                prior_state, prior_version = pool.swap_predictor(
                    idx, warmed[idx], version=target,
                    timeout=self.swap_timeout_s)
            except TimeoutError as e:
                reason = f"replica {idx} refused to quiesce: {e}"
                break
            swapped.append((idx, prior_state, prior_fp,
                            prior_version))
            _M_FLEET.inc(event="replica_swapped")
            firing = self._bake()
            if firing:
                reason = ("slo burn firing mid-rollout: %s"
                          % ",".join(firing))
                break
        # 3. catch-up: a replica the autoscaler added MID-rollout is
        # not in the snapshot (it still serves the pre-rollout
        # program) — prewarm-and-swap late joiners before the
        # straggler check, so a concurrent scale-up cannot force a
        # spurious full rollback.  Bounded passes: if scale-ups outrun
        # the catch-up, the straggler check below still rolls back.
        for _ in range(3):
            if reason:
                break
            late = [r.index for r in pool.replicas
                    if r.alive and not r.retired
                    and r.predictor.program_fingerprint() != target_fp]
            if not late:
                break
            for idx in late:
                try:
                    rep = pool.replica(idx)
                    prior_fp = rep.predictor.program_fingerprint()
                    if prior_fp == target_fp:
                        continue
                    prior_state, prior_version = pool.swap_predictor(
                        idx, target.prewarm(
                            buckets=self.server.config.buckets),
                        version=target, timeout=self.swap_timeout_s)
                except KeyError:
                    continue     # scaled away again: nothing to swap
                except (TimeoutError, PrewarmFailedError) as e:
                    reason = f"late replica {idx} swap failed: {e}"
                    break
                swapped.append((idx, prior_state, prior_fp,
                                prior_version))
                _M_FLEET.inc(event="replica_swapped")
                firing = self._burn_firing()
                if firing:
                    reason = ("slo burn firing mid-rollout: %s"
                              % ",".join(firing))
                    break
        if not reason:
            # 4. converged: every live replica must carry the target
            # fingerprint (a replica relaunched mid-rollout kept its
            # swapped predictor object, so this holds by construction)
            stragglers = [
                r.index for r in pool.replicas
                if r.alive and not r.retired
                and r.predictor.program_fingerprint() != target_fp]
            if stragglers:
                reason = f"stragglers after swap loop: {stragglers}"
        if reason:
            return self._rollback(name, target, swapped, reason, t0)
        with self._lock:
            self.state = "converged"
        self.server.model_version = target
        # future scale-ups must serve what their version tag claims:
        # point the pool factory at the converged version (prewarmed
        # like the rollout's own predictors)
        buckets = self.server.config.buckets
        pool.set_factory(
            lambda i, _v=target, _b=buckets: _v.prewarm(buckets=_b))
        _G_VERSION.set(target.version, model=str(name))
        _M_FLEET.inc(event="rollout_converged")
        _flight.record("fleet", "rollout_converged", model=str(name),
                       version=target.version, swapped=len(swapped))
        res = RolloutResult(
            "converged", str(name), target, len(swapped),
            wall_s=time.monotonic() - t0,
            from_fingerprints={i: fp for i, _, fp, _ in swapped})
        self.history.append(res)
        return res

    def _rollback(self, name, target, swapped, reason, t0):
        """Restore every swapped replica to its exact prior program
        (fingerprint-verified), newest first."""
        with self._lock:
            self.state = "rolling_back"
        _flight.record("fleet", "rollout_rolling_back",
                       model=str(name), version=target.version,
                       reason=reason[:200])
        failures = []
        for idx, prior_state, prior_fp, prior_version in \
                reversed(swapped):
            try:
                self.server.pool.swap_predictor(
                    idx, prior_state, version=prior_version,
                    timeout=self.swap_timeout_s)
                now_fp = self.server.pool.replica(idx) \
                    .predictor.program_fingerprint()
                if now_fp != prior_fp:
                    failures.append(
                        f"replica {idx}: fingerprint {now_fp} != "
                        f"prior {prior_fp}")
            except (KeyError, TimeoutError) as e:
                failures.append(f"replica {idx}: {e}")
        if failures:
            with self._lock:
                self.state = "idle"
            raise RolloutError(
                "rollback incomplete after '%s': %s"
                % (reason, "; ".join(failures)))
        with self._lock:
            self.state = "rolled_back"
        _M_FLEET.inc(event="rollout_rolled_back")
        _flight.record("fleet", "rollout_rolled_back",
                       model=str(name), version=target.version,
                       restored=len(swapped), reason=reason[:200])
        res = RolloutResult(
            "rolled_back", str(name), target, len(swapped),
            rolled_back=len(swapped), reason=reason,
            wall_s=time.monotonic() - t0,
            from_fingerprints={i: fp for i, _, fp, _ in swapped})
        self.history.append(res)
        return res


class SLOAutoscaler:
    """Actuates ReplicaPool size from the SLO burn-rate signal.

    ``evaluate()`` is one control tick (the background thread started
    by ``start()`` just calls it on an interval — tests drive it
    directly with a stub monitor): read the watched SLO's burn rates,
    update the hot/cold streaks, and scale when a streak clears its
    consecutive-tick bar outside the cooldown.  Scale-up adds
    ``step`` replicas through the predictor factory; scale-down
    retires the newest replica THROUGH GRACEFUL DRAIN
    (ReplicaPool.remove_replica — the in-flight batch delivers
    first).  Returns the action taken ("up"/"down"/None)."""

    def __init__(self, server, monitor, slo="serving_availability",
                 min_replicas=1, max_replicas=4, burn_up=2.0,
                 burn_clear=0.5, up_consecutive=2, down_consecutive=4,
                 cooldown_s=1.0, step=1, quiesce_timeout_s=10.0):
        if max_replicas < min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if burn_clear >= burn_up:
            raise ValueError(
                "hysteresis needs burn_clear < burn_up "
                f"(got {burn_clear} >= {burn_up})")
        self.server = server
        self.monitor = monitor
        self.slo = str(slo)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.burn_up = float(burn_up)
        self.burn_clear = float(burn_clear)
        self.up_consecutive = int(up_consecutive)
        self.down_consecutive = int(down_consecutive)
        self.cooldown_s = float(cooldown_s)
        self.step = int(step)
        self.quiesce_timeout_s = float(quiesce_timeout_s)
        self.events: list = []       # (t, "up"/"down", live_after)
        self._hot_streak = 0
        self._cold_streak = 0
        self._last_action_t = -float("inf")
        self._thread = None
        self._stop = threading.Event()

    @property
    def pool(self):
        return self.server.pool

    def _live(self):
        return len([r for r in self.pool.replicas
                    if r.alive and not r.retired])

    # -- the control tick ---------------------------------------------------
    def evaluate(self, now=None):
        now = time.monotonic() if now is None else float(now)
        try:
            evals = self.monitor.observe()
        except Exception:
            return None          # a monitor bug must never scale
        e = (evals or {}).get(self.slo)
        if e is None:
            return None
        fast, slow = e.get("burn_rate_fast"), e.get("burn_rate_slow")
        hot = e.get("firing") or (
            fast is not None and slow is not None
            and fast >= self.burn_up and slow >= self.burn_up)
        cold = (fast is None and slow is None) or (
            (fast or 0.0) <= self.burn_clear
            and (slow or 0.0) <= self.burn_clear)
        self._hot_streak = self._hot_streak + 1 if hot else 0
        self._cold_streak = self._cold_streak + 1 if cold else 0
        if now - self._last_action_t < self.cooldown_s:
            return None          # cooldown: no flapping
        live = self._live()
        if hot and self._hot_streak >= self.up_consecutive \
                and live < self.max_replicas:
            ver = getattr(self.server, "model_version", None)
            buckets = getattr(getattr(self.server, "config", None),
                              "buckets", None)
            n = min(self.step, self.max_replicas - live)
            for _ in range(n):
                # the new replica must SERVE the version its tag
                # claims: build it from the registry version (prewarmed
                # off the serving path), not from a possibly
                # pre-rollout factory
                pred = None
                if hasattr(ver, "prewarm"):
                    try:
                        pred = ver.prewarm(buckets=buckets) \
                            if buckets else ver.prewarm()
                    except PrewarmFailedError as e:
                        _flight.record(
                            "fleet", "scale_up_prewarm_failed",
                            version=str(ver), error=str(e)[:200])
                        return None   # never add a broken replica
                self.pool.add_replica(version=ver, predictor=pred)
            return self._acted("up", now, burn_fast=fast,
                               burn_slow=slow)
        if cold and self._cold_streak >= self.down_consecutive \
                and live > self.min_replicas:
            try:
                self.pool.remove_replica(
                    timeout=self.quiesce_timeout_s)
            except (RuntimeError, TimeoutError):
                return None      # drain refused: try again next tick
            return self._acted("down", now, burn_fast=fast,
                               burn_slow=slow)
        return None

    def _acted(self, direction, now, **fields):
        self._last_action_t = now
        self._hot_streak = 0
        self._cold_streak = 0
        live = self._live()
        self.events.append((now, direction, live))
        _M_FLEET.inc(event="scale_%s" % direction)
        _G_REPLICAS.set(live)
        _flight.record("fleet", "scale_%s" % direction, live=live,
                       **{k: (round(v, 3) if isinstance(v, float)
                              else v)
                          for k, v in fields.items() if v is not None})
        return direction

    def scale_events(self):
        return list(self.events)

    # -- background loop ----------------------------------------------------
    def start(self, interval_s=0.25):
        if self._thread is None:
            self._stop.clear()

            def loop():
                while not self._stop.wait(interval_s):
                    try:
                        self.evaluate()
                    except Exception:   # the autoscaler must never
                        pass            # take the server down
            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._thread = None
