"""Static program analysis of the port: the structural IR verifier and
the static sharding check.

Counterpart of ``paddle_tpu/analysis`` (``verifier.py`` whole,
``verify_level``/``verify_enabled`` of ``passes.py:35-44`` and
``check_sharding`` of ``shape_check.py:206-312``).  The flag
``ir_verify`` ("off" by default) gates where the port calls ``verify``:
the model registry at registration and at prewarm, ``checked_pass``
around the collective and sharding transpilers, and ``check_sharding``
after the annotation passes.  ``checked_pass`` around the other
transpilers and the static shape check of ``shape_check.py`` are not
ported yet (ROADMAP Queue 1 item 6).
"""

from paddle_tpu_torch.analysis.verifier import (  # noqa: F401
    Diagnostic, VerifierError, verify, verify_roundtrip)
from paddle_tpu_torch.analysis.passes import (  # noqa: F401
    checked_pass, verify_enabled, verify_level)

__all__ = [
    "Diagnostic", "VerifierError", "verify", "verify_roundtrip",
    "checked_pass", "verify_enabled", "verify_level",
]
