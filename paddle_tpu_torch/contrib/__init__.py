"""contrib: the ported incubating subsystems (counterpart of
``paddle_tpu/contrib/``).  Only ``float16`` and ``mixed_precision``
are ported yet."""

from paddle_tpu_torch.contrib import float16  # noqa: F401
from paddle_tpu_torch.contrib import mixed_precision  # noqa: F401
