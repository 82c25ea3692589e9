"""paddle_tpu_torch — the PyTorch and CUDA port of paddle_tpu.

The same Fluid-style programs (Program/Block/OpDesc IR, the op registry,
Executor, append_backward and the optimizers, inference Predictor) run
on torch tensors, and the TPU's Pallas kernels become kernels written by
hand for NVIDIA Hopper (``csrc/``).
The port imports no JAX and nothing of ``paddle_tpu``; a program or an
inference model saved by either package loads in the other.

Entry points run on the GPU unless asked for the CPU: ``Executor()``
means ``CUDAPlace(0)`` and ``inference.Config`` uses the GPU until
``disable_gpu()``.  Without a CUDA device they raise.
"""

from paddle_tpu_torch.core.types import (CPUPlace, CUDAPlace,  # noqa: F401
                                         NoCUDADeviceError, VarType)
from paddle_tpu_torch.core.program import (Block, OpDesc,  # noqa: F401
                                           Program, VarDesc)
from paddle_tpu_torch.core.scope import (Scope, Variable,  # noqa: F401
                                         global_scope, scope_guard)
from paddle_tpu_torch.core.executor import Executor  # noqa: F401
from paddle_tpu_torch.core.compiler import CompiledProgram  # noqa: F401
from paddle_tpu_torch.framework import (  # noqa: F401
    default_main_program, default_startup_program, program_guard,
    switch_main_program, switch_startup_program)
from paddle_tpu_torch import ops  # noqa: F401  (registers every op)
from paddle_tpu_torch import layers  # noqa: F401
from paddle_tpu_torch import initializer  # noqa: F401
from paddle_tpu_torch import optimizer  # noqa: F401
from paddle_tpu_torch import backward  # noqa: F401
from paddle_tpu_torch.backward import append_backward, gradients  # noqa: F401,E501
from paddle_tpu_torch.optimizer import (SGD, Adam, Momentum,  # noqa: F401
                                        AdamOptimizer, MomentumOptimizer,
                                        SGDOptimizer)
from paddle_tpu_torch import io  # noqa: F401
from paddle_tpu_torch import inference  # noqa: F401
from paddle_tpu_torch import unique_name  # noqa: F401
from paddle_tpu_torch.param_attr import ParamAttr  # noqa: F401
from paddle_tpu_torch import transpiler  # noqa: F401
from paddle_tpu_torch import contrib  # noqa: F401
from paddle_tpu_torch.flags import get_flag, set_flags  # noqa: F401
