from paddle_tpu_torch.transpiler.inference_transpiler import (  # noqa: F401
    FuseElewiseAddActTranspiler, FuseFCTranspiler, InferenceTranspiler)
from paddle_tpu_torch.transpiler.epilogue_transpiler import (  # noqa: F401
    EpilogueFusionTranspiler, fuse_conv_bn_train, fuse_conv_epilogue,
    fuse_epilogue)
from paddle_tpu_torch.transpiler.layout_transpiler import (  # noqa: F401
    nhwc_transpile, space_to_depth_stem)
