"""contrib: the ported incubating subsystems (counterpart of
``paddle_tpu/contrib/``).  Only ``float16``, ``mixed_precision``,
``slim``'s post-training int8 passes and ``checkpoint`` (in a format of
the port's own) are ported yet."""

from paddle_tpu_torch.contrib import float16  # noqa: F401
from paddle_tpu_torch.contrib import mixed_precision  # noqa: F401
from paddle_tpu_torch.contrib import slim  # noqa: F401
