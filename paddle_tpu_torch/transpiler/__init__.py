from paddle_tpu_torch.transpiler.collective import (  # noqa: F401
    Collective, GradAllReduce, LocalSGD)
from paddle_tpu_torch.transpiler.details import wait_server_ready  # noqa: F401
from paddle_tpu_torch.transpiler.distribute_transpiler import (  # noqa: F401
    DistributeTranspiler, DistributeTranspilerConfig, slice_variable)
from paddle_tpu_torch.transpiler.inference_transpiler import (  # noqa: F401
    FuseElewiseAddActTranspiler, FuseFCTranspiler, InferenceTranspiler)
from paddle_tpu_torch.transpiler.epilogue_transpiler import (  # noqa: F401
    EpilogueFusionTranspiler, fold_int8_interlayer, fuse_conv_bn_train,
    fuse_conv_epilogue, fuse_epilogue)
from paddle_tpu_torch.transpiler.layout_transpiler import (  # noqa: F401
    nhwc_transpile, space_to_depth_stem)
from paddle_tpu_torch.transpiler.ps_dispatcher import (  # noqa: F401
    HashName, PSDispatcher, RoundRobin)
