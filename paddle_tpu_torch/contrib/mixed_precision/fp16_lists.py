"""White, black and gray op lists for automatic mixed precision.

Counterpart of ``paddle_tpu/contrib/mixed_precision/fp16_lists.py``, with
the same lists, so ``rewrite_program`` inserts the same casts in both
packages: white ops compute in the low dtype (bf16), black ops in f32,
gray ops in whatever dtype arrives.
"""

from __future__ import annotations

import copy

# matrix products and the kernels built on them: bf16 operands with an
# f32 accumulator (the flash kernel keeps its softmax statistics in f32;
# the fc_epilogue kernel applies its epilogue to the f32 accumulator)
white_list = {
    "conv2d", "depthwise_conv2d", "conv2d_transpose", "matmul", "mul",
    "flash_attention", "conv2d_epilogue", "conv2d_bn_train", "fc_epilogue",
}

# numerically sensitive: keep f32
black_list = {
    "exp", "square", "log", "mean", "sum", "cos_sim",
    "softmax", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "cross_entropy", "cross_entropy2",
    "reduce_sum", "reduce_mean",
}

# dtype-agnostic: run in whatever dtype arrives
gray_list = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
    "batch_norm", "layer_norm", "tanh", "sigmoid", "lookup_table",
    "relu", "relu6", "leaky_relu", "soft_relu", "top_k", "pool2d",
    "dropout", "reshape2", "transpose2", "transpose", "concat", "split",
    "slice", "flatten2", "stack", "unstack", "expand", "scale", "cast",
    "elementwise_op", "squeeze2", "unsqueeze2", "pad", "pad2d", "gather",
    "swapaxes", "flip", "assign", "space_to_depth",
}

# normalisation ops whose output dtype follows X (their statistics stay
# f32 inside the op)
follow_x_list = {
    "batch_norm", "sync_batch_norm", "layer_norm", "group_norm",
    "instance_norm", "data_norm",
}


class AutoMixedPrecisionLists:
    """The base lists plus a caller's custom white and black ops."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = copy.copy(white_list)
        self.black_list = copy.copy(black_list)
        self.gray_list = copy.copy(gray_list)
        if custom_white_list:
            for op in custom_white_list:
                self.white_list.add(op)
                self.black_list.discard(op)
                self.gray_list.discard(op)
        if custom_black_list:
            for op in custom_black_list:
                self.black_list.add(op)
                self.white_list.discard(op)
                self.gray_list.discard(op)
        overlap = self.white_list & self.black_list
        if overlap:
            raise ValueError(f"ops in both white and black lists: {overlap}")
