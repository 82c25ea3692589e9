"""Operator library of the torch port; importing it registers every op."""

from paddle_tpu_torch.ops import basic  # noqa: F401
from paddle_tpu_torch.ops import nn  # noqa: F401
from paddle_tpu_torch.ops import fused_ops  # noqa: F401
from paddle_tpu_torch.ops import io_ops  # noqa: F401
from paddle_tpu_torch.ops import flash_attention  # noqa: F401
from paddle_tpu_torch.ops import optim  # noqa: F401
from paddle_tpu_torch.ops import amp  # noqa: F401
from paddle_tpu_torch.ops import epilogue  # noqa: F401
from paddle_tpu_torch.ops import conv_epilogue  # noqa: F401
from paddle_tpu_torch.ops import metrics  # noqa: F401
from paddle_tpu_torch.ops import flash_decode  # noqa: F401
from paddle_tpu_torch.ops import control_flow  # noqa: F401
from paddle_tpu_torch.ops import quant  # noqa: F401
