"""The ``ir_verify`` flag's level (``paddle_tpu/analysis/passes.py:35-44``).

Levels (flag values): "off" (default), "on" (structural
``verifier.verify``) and "full" ("on" plus the static shape check in the
JAX package; the port has no shape check yet, ROADMAP Queue 1 item 6, so
"full" verifies as "on" does).  ``checked_pass``, the wrapper that
verifies before and after every transpiler pass, is not ported yet
(item 6).
"""

from __future__ import annotations

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
