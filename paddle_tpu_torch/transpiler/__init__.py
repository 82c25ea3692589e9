from paddle_tpu_torch.transpiler.inference_transpiler import (  # noqa: F401
    FuseElewiseAddActTranspiler, FuseFCTranspiler)
from paddle_tpu_torch.transpiler.epilogue_transpiler import (  # noqa: F401
    EpilogueFusionTranspiler, fuse_epilogue)
