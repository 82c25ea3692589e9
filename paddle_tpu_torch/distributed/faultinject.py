"""Deterministic fault injection for the RPC wire transports.

The reference stack earns its retry/deadline machinery (grpc_client
deadline loops, BRPC health checks) against real clusters; this shim
lets us earn ours against *reproducible* clusters: a seedable,
plan-driven chaos layer that both wire transports (socket framing in
rpc.py, HTTP framing in http_transport.py) consult on the SERVER side
after decoding each request.  A fault is keyed by ``(msg_type,
call_index)`` where call_index counts requests of that msg_type seen by
this process's injector — the same plan therefore always faults the
same calls, so a failure found by the chaos soak replays exactly.

Actions (what the peer observes):

  ``drop``          handler RUNS (side effects + dedup cache land), the
                    reply is discarded and the connection closed —
                    reply-loss.  A retrying client must get the cached
                    reply, not a second execution (exactly-once proof).
  ``close``         connection closed after reading the request, the
                    handler never runs — request-loss.  Retry re-runs
                    the handler; safe for every class.
  ``kill``          the handler thread is killed at entry and the
                    connection aborted without a reply — a crashed
                    handler thread (distinct from ``close`` in the
                    injection log, same peer-observable outcome).
  ``delay=S``       handler runs, the reply is delayed S seconds —
                    latency spike / deadline exercise.
  ``truncate[=F]``  handler runs, only the first F (default 0.5)
                    fraction of the reply frame is written, then the
                    connection closes mid-frame — wire corruption.

Plan grammar (``PADDLE_TPU_FAULT_PLAN`` or ``FaultPlan.parse``):

    plan  := item (';' item)*
    item  := rule | knob
    rule  := msg_type '@' index ':' action      # send_var@0:drop
    action:= step ('+' step)*                   # delay=0.2+truncate
    step  := drop | close | kill | delay=SECONDS | truncate[=FRACTION]
    knob  := seed=N | rate=P | actions=a,b,... | max=N

A '+'-combined action applies every step to the SAME request in order
(non-final steps must be ``delay``; ``close``/``kill`` stand alone):
``delay=0.2+truncate`` runs the handler, holds the reply 0.2 s, then
writes it truncated and closes mid-frame.

``msg_type`` may be ``*`` (any type; index counts per-type).  With
``seed``/``rate`` set, every call is additionally faulted with
probability ``rate``, deterministically derived from
``hash(seed, msg_type, call_index)`` — same seed, same faults.  ``max``
bounds the total number of injected faults (randomized and explicit).

Zero overhead when off: transports make one ``maybe_injector()`` call
per request, which is a dict lookup returning None unless a plan is
installed programmatically or present in the environment.

    plan = FaultPlan().on("send_var", 0, "drop").on("get_var", 2,
                                                    "delay=0.2")
    with installed(plan) as inj:
        ...run cluster...
        assert inj.log  # [(msg_type, index, action), ...]
"""

from __future__ import annotations

import hashlib
import os
import threading

__all__ = [
    "FaultPlan", "FaultInjector", "install", "uninstall", "installed",
    "maybe_injector", "steps_of",
]

_ACTIONS = ("drop", "close", "kill", "delay", "truncate")


def _parse_single(text):
    """'delay=0.5' -> ('delay', 0.5); validates kind + argument."""
    kind, _, arg = text.partition("=")
    kind = kind.strip()
    if kind not in _ACTIONS:
        raise ValueError(
            f"unknown fault action {kind!r} (one of {_ACTIONS})")
    if kind == "delay":
        if not arg:
            raise ValueError("delay needs a duration: delay=SECONDS")
        return ("delay", float(arg))
    if kind == "truncate":
        frac = float(arg) if arg else 0.5
        if not 0.0 <= frac < 1.0:
            raise ValueError("truncate fraction must be in [0, 1)")
        return ("truncate", frac)
    if arg:
        raise ValueError(f"action {kind!r} takes no argument")
    return (kind, None)


def _parse_action(text):
    """One action, or a '+'-combined chain applied to the SAME request
    (e.g. ``delay=0.2+truncate``: handler runs, reply is held 0.2 s,
    then written truncated — a latency spike that ends in wire
    corruption, the failure shape a slow-then-dying peer produces).

    Chain rules: every non-final step must be ``delay`` (the only
    action with a pure-latency effect); the final step may be
    ``delay``, ``drop`` or ``truncate``; ``close``/``kill`` stand
    alone (the handler never runs, so a preceding delay would claim
    latency the peer can't observe).  A single action parses exactly
    as before: ('kind', arg).  A chain parses to ('seq', ((kind, arg),
    ...)); transports normalize via ``steps_of``.
    """
    parts = [p.strip() for p in str(text).split("+")]
    if len(parts) == 1:
        return _parse_single(parts[0])
    steps = tuple(_parse_single(p) for p in parts)
    for kind, _ in steps:
        if kind in ("close", "kill"):
            raise ValueError(
                f"action {kind!r} cannot be combined (handler never "
                "runs, a chained step could not be observed)")
    for kind, _ in steps[:-1]:
        if kind != "delay":
            raise ValueError(
                "only 'delay' may precede another action in a chain "
                f"(got {kind!r} before the final step)")
    return ("seq", steps)


def steps_of(action):
    """Normalize a decide() result to its ordered step list:
    ('drop', None) -> [('drop', None)]; ('seq', steps) -> list(steps)."""
    kind, arg = action
    return list(arg) if kind == "seq" else [(kind, arg)]


def action_name(action):
    """Loggable name: 'drop', or 'delay+truncate' for a chain."""
    return "+".join(kind for kind, _ in steps_of(action))


def _action_text(action):
    """Inverse of _parse_action (single step or chain)."""
    steps = steps_of(action)
    return "+".join(kind if arg is None else f"{kind}={arg}"
                    for kind, arg in steps)


# ---------------------------------------------------------------------------
# msg-type registry.  Every injectable fault
# point — RPC wire types (RPCServer.register_handler registers them
# here automatically) and local serving fault points (their MSG_*
# constants are defined as register_msg_type(...) calls) — lands in
# this advisory set, so tools/repo_lint.py can statically check that
# every msg type consulted at a decide() site is a REAL fault point
# (a typo'd plan rule otherwise just never fires).  Advisory on
# purpose at runtime: plans legally install before any server
# registers its handlers.
# ---------------------------------------------------------------------------

KNOWN_MSG_TYPES: set = set()


def register_msg_type(name: str) -> str:
    """Record ``name`` as an injectable fault point; returns it (so
    ``MSG_X = register_msg_type("x")`` reads as a declaration)."""
    KNOWN_MSG_TYPES.add(str(name))
    return str(name)


class FaultPlan:
    """Explicit rules keyed by (msg_type, call_index) plus an optional
    seeded random component.  Build programmatically with .on() / knob
    kwargs, or from text with FaultPlan.parse()."""

    def __init__(self, seed=None, rate=0.0, actions=("drop", "close"),
                 max_faults=None):
        self.rules: dict = {}
        self.seed = None if seed is None else int(seed)
        self.rate = float(rate)
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        self.random_actions = tuple(actions)
        for a in self.random_actions:
            _parse_action(a)
        self.max_faults = None if max_faults is None else int(max_faults)
        if self.rate and self.seed is None:
            raise ValueError("rate > 0 requires a seed (determinism)")

    def on(self, msg_type, call_index, action):
        """Fault call number `call_index` (0-based, per msg_type) of
        `msg_type` ('*' = any type) with `action` (grammar above)."""
        self.rules[(str(msg_type), int(call_index))] = \
            _parse_action(str(action))
        return self

    @classmethod
    def parse(cls, text):
        rules = {}
        knobs = {"seed": None, "rate": 0.0,
                 "actions": ("drop", "close"), "max": None}
        for item in str(text).split(";"):
            item = item.strip()
            if not item:
                continue
            head, sep, tail = item.partition(":")
            if sep and "@" in head:
                mt, _, idx = head.rpartition("@")
                try:
                    idx = int(idx)
                except ValueError:
                    raise ValueError(
                        f"bad fault rule {item!r}: index must be an int")
                rules[(mt.strip(), idx)] = _parse_action(tail.strip())
                continue
            key, sep, val = item.partition("=")
            key = key.strip()
            if not sep or key not in knobs:
                raise ValueError(
                    f"bad fault plan item {item!r} (rule 'type@i:action'"
                    " or knob seed=/rate=/actions=/max=)")
            if key == "actions":
                knobs[key] = tuple(a.strip() for a in val.split(",") if a)
            elif key == "seed" or key == "max":
                knobs[key] = int(val)
            else:
                knobs[key] = float(val)
        plan = cls(seed=knobs["seed"], rate=knobs["rate"],
                   actions=knobs["actions"], max_faults=knobs["max"])
        plan.rules.update(rules)
        return plan

    def to_text(self):
        """Inverse of parse() (chaos_soak records reproducible plans)."""
        items = []
        if self.seed is not None:
            items.append(f"seed={self.seed}")
        if self.rate:
            items.append(f"rate={self.rate}")
            items.append("actions=" + ",".join(self.random_actions))
        if self.max_faults is not None:
            items.append(f"max={self.max_faults}")
        for (mt, idx), action in sorted(self.rules.items()):
            items.append(f"{mt}@{idx}:{_action_text(action)}")
        return ";".join(items)


class FaultInjector:
    """Stateful executor of a FaultPlan: per-msg_type call counters, a
    total-fault bound, and a log of every fault applied."""

    def __init__(self, plan):
        self.plan = plan
        self.log = []
        self._counts: dict = {}
        self._lock = threading.Lock()

    def _random_action(self, msg_type, idx):
        p = self.plan
        if not p.rate:
            return None
        h = hashlib.sha256(
            f"{p.seed}:{msg_type}:{idx}".encode()).digest()
        u = int.from_bytes(h[:8], "big") / 2.0 ** 64
        if u >= p.rate:
            return None
        pick = int.from_bytes(h[8:12], "big") % len(p.random_actions)
        return _parse_action(p.random_actions[pick])

    def decide(self, msg_type):
        """Next call of `msg_type` arrived: return ('kind', arg) to
        fault it, else None.  Counts every call, faulted or not."""
        with self._lock:
            idx = self._counts.get(msg_type, 0)
            self._counts[msg_type] = idx + 1
            if self.plan.max_faults is not None and \
                    len(self.log) >= self.plan.max_faults:
                return None
            act = self.plan.rules.get((msg_type, idx)) \
                or self.plan.rules.get(("*", idx)) \
                or self._random_action(msg_type, idx)
            if act is not None:
                self.log.append((msg_type, idx, action_name(act)))
                # chaos actions join the flight-recorder narrative so a
                # post-mortem dump shows WHAT was injected right before
                # the failure it caused
                from paddle_tpu_torch.observability import flight_recorder

                flight_recorder.record(
                    "chaos", action_name(act), msg_type=msg_type,
                    call_index=idx)
            return act

    def counts(self):
        with self._lock:
            return dict(self._counts)


# -- process-wide installation ------------------------------------------
_installed = None
_env_cache = (None, None)   # (env text, injector built from it)
_state_lock = threading.Lock()


def install(plan):
    """Install a plan (or a prebuilt FaultInjector) process-wide;
    returns the injector (its .log records applied faults).  Overrides
    any PADDLE_TPU_FAULT_PLAN in the environment."""
    global _installed
    inj = plan if isinstance(plan, FaultInjector) else FaultInjector(plan)
    with _state_lock:
        _installed = inj
    return inj


def uninstall():
    global _installed
    with _state_lock:
        _installed = None


class installed:
    """Context manager: install(plan) on enter, uninstall on exit."""

    def __init__(self, plan):
        self._plan = plan

    def __enter__(self):
        return install(self._plan)

    def __exit__(self, *exc):
        uninstall()
        return False


def maybe_injector():
    """The per-request hook the transports call: None (the common case,
    one dict lookup) unless a plan is installed programmatically or via
    PADDLE_TPU_FAULT_PLAN.  The env plan is parsed once per distinct
    env value, so monkeypatched tests see their own plans."""
    inj = _installed
    if inj is not None:
        return inj
    text = os.environ.get("PADDLE_TPU_FAULT_PLAN")
    if not text:
        return None
    global _env_cache
    with _state_lock:
        if _env_cache[0] != text:
            _env_cache = (text, FaultInjector(FaultPlan.parse(text)))
        return _env_cache[1]
