"""Automatic mixed precision (counterpart of
``paddle_tpu/contrib/mixed_precision/``)."""

from paddle_tpu_torch.contrib.mixed_precision.decorator import (
    OptimizerWithMixedPrecision,
    decorate,
)
from paddle_tpu_torch.contrib.mixed_precision.fp16_lists import (
    AutoMixedPrecisionLists,
)
from paddle_tpu_torch.contrib.mixed_precision.fp16_utils import \
    rewrite_program

__all__ = ["decorate", "OptimizerWithMixedPrecision",
           "AutoMixedPrecisionLists", "rewrite_program"]
