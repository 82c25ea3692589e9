"""contrib: the ported incubating subsystems (counterpart of
``paddle_tpu/contrib/``).  Only ``mixed_precision`` is ported yet."""

from paddle_tpu_torch.contrib import mixed_precision  # noqa: F401
