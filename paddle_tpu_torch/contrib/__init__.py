"""contrib: the ported incubating subsystems (counterpart of
``paddle_tpu/contrib/``).  Only ``float16``, ``mixed_precision`` and
``slim``'s post-training int8 passes are ported yet."""

from paddle_tpu_torch.contrib import float16  # noqa: F401
from paddle_tpu_torch.contrib import mixed_precision  # noqa: F401
from paddle_tpu_torch.contrib import slim  # noqa: F401
