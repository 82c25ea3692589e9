"""The ``ir_verify`` flag's level (``paddle_tpu/analysis/passes.py:35-44``).

Levels (flag values): "off" (default), "on" (structural
``verifier.verify``) and "full" ("on" plus the static shape check in the
JAX package; the port has no shape check yet, ROADMAP Queue 1 item 6, so
"full" verifies as "on" does).

``checked_pass(name)`` wraps a pass entry point (``paddle_tpu/analysis/
passes.py:57-112``): at "off" it runs the pass and bumps the IR mutation
counter (the fingerprint memo's boundary); at "on" the structural
verifier runs over every Program argument before and after the pass
(``<name>:before``/``<name>:after``) and over every Program the pass
returns (``<name>:output``).  The port's passes that carry it so far are
the collective transpilers (``transpiler/collective.py``); the others
wait for item 6.
"""

from __future__ import annotations

import functools

from paddle_tpu_torch import flags

_LEVELS = ("off", "on", "full")


def verify_level() -> str:
    """Current ir_verify level, normalized ('off'|'on'|'full')."""
    v = str(flags.get_flag("ir_verify")).lower()
    if v in ("1", "true", "yes"):
        return "on"
    return v if v in _LEVELS else "off"


def verify_enabled() -> bool:
    return verify_level() != "off"


def _programs_in(args, kwargs):
    from paddle_tpu_torch.core.program import Program

    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, Program) and a not in out:
            out.append(a)
    return out


def checked_pass(name):
    """Decorator bracketing an IR-mutating pass entry point with the
    structural verifier.  Every ``Program`` found in the call's arguments
    is verified before the pass and re-verified after it."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from paddle_tpu_torch.analysis import verifier
            from paddle_tpu_torch.core.program import _bump_ir_mutation

            if verify_level() == "off":
                try:
                    return fn(*args, **kwargs)
                finally:
                    _bump_ir_mutation()
            programs = _programs_in(args, kwargs)
            for p in programs:
                verifier.verify(p, label=f"{name}:before")
            try:
                out = fn(*args, **kwargs)
            finally:
                _bump_ir_mutation()
            for p in programs:
                verifier.verify(p, label=f"{name}:after")
            for p in _programs_in(
                    out if isinstance(out, (list, tuple)) else (out,), {}):
                if p not in programs:
                    verifier.verify(p, label=f"{name}:output")
            return out

        wrapper.__wrapped_pass__ = name
        return wrapper

    return deco
