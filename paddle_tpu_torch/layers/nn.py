"""Layer functions building the IR.

Counterpart of ``paddle_tpu/layers/nn.py``: the layers the Transformer LM,
ResNet, BERT and DeepFM call, and the families of their ops, emitting the same op types, slots, attrs, var names and
startup ops as the JAX package.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.types import dtype_name
from paddle_tpu_torch.layers.helper import LayerHelper

__all__ = [
    "fc", "embedding", "layer_norm", "scale", "reshape", "transpose",
    "flash_attention", "mean", "square_error_cost",
    "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "cast", "conv2d", "pool2d",
    "batch_norm", "softmax", "topk", "accuracy", "dropout",
    # activations
    "relu", "sigmoid", "tanh", "sqrt", "square", "abs", "exp", "log",
    "softplus", "softsign", "relu6", "leaky_relu", "gelu", "elu", "swish",
    "hard_sigmoid", "pow",
    # reductions, products, the elementwise family
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "reduce_all", "reduce_any", "matmul", "elementwise_op",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow",
    # tensor manipulation
    "concat", "slice", "one_hot",
]


def _single_out(op_type, x, attrs=None, ins_extra=None, in_slot="X",
                out_dtype=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(out_dtype or x.dtype)
    inputs = {in_slot: x}
    inputs.update(ins_extra or {})
    helper.append_op(type=op_type, inputs=inputs, outputs={"Out": out},
                     attrs=attrs or {})
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """``mul`` + bias ``elementwise_add`` (axis ``num_flatten_dims``) +
    optional activation op."""
    helper = LayerHelper("fc", name=name)
    in_dim = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, [in_dim, size], input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="mul", inputs={"X": input, "Y": w}, outputs={"Out": out},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], input.dtype,
                                    is_bias=True)
        out2 = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(
            type="elementwise_add", inputs={"X": out, "Y": b},
            outputs={"Out": out2}, attrs={"axis": num_flatten_dims})
        out = out2
    return helper.append_activation(out, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, list(size), dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="lookup_table", inputs={"W": w, "Ids": input},
        outputs={"Out": out},
        attrs={"padding_idx": -1 if padding_idx is None else padding_idx,
               "is_sparse": is_sparse, "is_distributed": is_distributed})
    return out


def _pair_attr(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None,
           use_cudnn=True, data_format="NCHW"):
    """``conv2d`` with an OIHW filter (MSRA uniform by default), then a
    channel-bias ``elementwise_add`` unless ``bias_attr`` is False, then
    the activation op."""
    from paddle_tpu_torch.initializer import MSRA

    helper = LayerHelper("conv2d", name=name)
    c_in = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    fs = filter_size if isinstance(filter_size, (list, tuple)) else (
        filter_size, filter_size)
    w = helper.create_parameter(
        param_attr, [num_filters, c_in // groups, fs[0], fs[1]],
        input.dtype, default_initializer=MSRA(uniform=True))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="conv2d", inputs={"Input": input, "Filter": w},
        outputs={"Output": out},
        attrs={"strides": _pair_attr(stride),
               "paddings": _pair_attr(padding),
               "dilations": _pair_attr(dilation),
               "groups": groups, "data_format": data_format})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        out2 = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(
            type="elementwise_add", inputs={"X": out, "Y": b},
            outputs={"Out": out2},
            attrs={"axis": 1 if data_format == "NCHW" else -1})
        out = out2
    return helper.append_activation(out, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, adaptive=False, name=None, data_format="NCHW"):
    attrs = {
        "pooling_type": pool_type,
        "ksize": _pair_attr(pool_size),
        "global_pooling": global_pooling,
        "strides": _pair_attr(pool_stride),
        "paddings": _pair_attr(pool_padding),
        "ceil_mode": ceil_mode, "exclusive": exclusive,
        "adaptive": adaptive, "data_format": data_format,
    }
    return _single_out("pool2d", input, attrs)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False):
    """``batch_norm`` with scale (1), bias (0) and the running mean (0)
    and variance (1) as persistable parameters; the running statistics
    are not trainable and are updated by wiring MeanOut/VarianceOut back
    onto the same vars."""
    from paddle_tpu_torch.initializer import Constant
    from paddle_tpu_torch.param_attr import ParamAttr

    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(param_attr, [c], input.dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], input.dtype,
                                   is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False,
                  initializer=Constant(0.0)), [c], input.dtype)
    var = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False,
                  initializer=Constant(1.0)), [c], input.dtype)
    mean.stop_gradient = True
    var.stop_gradient = True
    y = helper.create_variable_for_type_inference(input.dtype)
    saved_mean = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True)
    helper.append_op(
        type="batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": var},
        outputs={"Y": y, "MeanOut": mean, "VarianceOut": var,
                 "SavedMean": saved_mean, "SavedVariance": saved_var},
        attrs={"epsilon": epsilon, "momentum": momentum,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y, act)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """Inference dropout (``paddle_tpu/layers/nn.py:311``): the same op
    and attrs.  In training the JAX layer feeds a persistable step
    counter (an ``increment`` op) into the op's SeedOffset; that and
    training dropout are not ported yet (ROADMAP Queue 1 item 6), so
    ``is_test=False`` raises."""
    if not is_test:
        raise NotImplementedError(
            "layers.dropout: training mode (is_test=False) is not ported "
            "yet (ROADMAP Queue 1 item 6)")
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(
        type="dropout", inputs={"X": x},
        outputs={"Out": out, "Mask": mask},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed or 0,
               "dropout_implementation": dropout_implementation})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    from paddle_tpu_torch.initializer import Constant

    helper = LayerHelper("layer_norm", name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            param_attr, norm_shape, input.dtype,
            default_initializer=Constant(1.0))
    if shift:
        inputs["Bias"] = helper.create_parameter(
            bias_attr, norm_shape, input.dtype, is_bias=True)
    y = helper.create_variable_for_type_inference(input.dtype)
    m = helper.create_variable_for_type_inference(input.dtype, True)
    v = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": y, "Mean": m, "Variance": v},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(y, act)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False,
                               numeric_stable_mode=True, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": logits, "Label": label},
        outputs={"Softmax": softmax_out, "Loss": loss},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "axis": axis, "numeric_stable_mode": numeric_stable_mode})
    if return_softmax:
        return loss, softmax_out
    return loss


def softmax(input, axis=-1, name=None, use_cudnn=False):
    return _single_out("softmax", input, {"axis": axis})


def topk(input, k, name=None):
    helper = LayerHelper("top_k")
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": input},
                     outputs={"Out": values, "Indices": indices},
                     attrs={"k": k})
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of ``input`` against ``label``: a ``top_k`` op, then
    an ``accuracy`` op (Accuracy f32, Correct and Total int64)."""
    helper = LayerHelper("accuracy")
    values, indices = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32")
    correct = correct or helper.create_variable_for_type_inference("int64")
    total = total or helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="accuracy",
        inputs={"Out": values, "Indices": indices, "Label": label},
        outputs={"Accuracy": acc, "Correct": correct, "Total": total})
    return acc


def mean(x, name=None):
    return _single_out("mean", x)


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="square_error_cost", inputs={"X": input, "Y": label},
        outputs={"Out": out},
    )
    return out


def cast(x, dtype):
    dtype = dtype_name(dtype)
    return _single_out("cast", x, {"out_dtype": dtype}, out_dtype=dtype)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="scale", inputs={"X": x}, outputs={"Out": out},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def reshape(x, shape, act=None, name=None):
    helper = LayerHelper("reshape2")
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="reshape2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2")
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="transpose2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": list(perm)})
    return out


def flash_attention(q, k, v, causal=False, scale=None, block_q=None,
                    block_k=None, name=None):
    """Fused attention over ``[B, H, T, D]`` q/k/v (the ``flash_attention``
    op; ``ops/flash_attention.py``).  ``block_q``/``block_k`` are kept in
    the IR for the JAX package and ignored by the port's kernel, as are
    the flags ``flash_packed_stats`` and ``flash_head_pack``."""
    return _single_out(
        "flash_attention", q,
        {"causal": causal, "scale": float(scale or 0.0),
         "block_q": int(block_q or 0), "block_k": int(block_k or 0)},
        ins_extra={"K": k, "V": v}, in_slot="Q")


# ---------------------------------------------------------------------------
# activations (``paddle_tpu/layers/nn.py:336-375``)
# ---------------------------------------------------------------------------

def _unary(op_type):
    def f(x, name=None):
        return _single_out(op_type, x)
    f.__name__ = op_type
    return f


relu = _unary("relu")
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
sqrt = _unary("sqrt")
square = _unary("square")
abs = _unary("abs")
exp = _unary("exp")
log = _unary("log")
softplus = _unary("softplus")
softsign = _unary("softsign")


def relu6(x, threshold=6.0, name=None):
    return _single_out("relu6", x, {"threshold": threshold})


def leaky_relu(x, alpha=0.02, name=None):
    return _single_out("leaky_relu", x, {"alpha": alpha})


def gelu(x, approximate=False, name=None):
    return _single_out("gelu", x, {"approximate": approximate})


def elu(x, alpha=1.0, name=None):
    return _single_out("elu", x, {"alpha": alpha})


def swish(x, beta=1.0, name=None):
    return _single_out("swish", x, {"beta": beta})


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _single_out("hard_sigmoid", x, {"slope": slope,
                                           "offset": offset})


def pow(x, factor=1.0, name=None):
    return _single_out("pow", x, {"factor": factor})


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": x, "Label": label}, outputs={"Out": out},
        attrs={"ignore_index": ignore_index, "normalize": normalize})
    return out


# ---------------------------------------------------------------------------
# reductions, matmul, the elementwise family (``:505-607``)
# ---------------------------------------------------------------------------

def _reduce(op_type, input, dim, keep_dim):
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    return _single_out(op_type, input, attrs)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_all", input, dim, keep_dim)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_any", input, dim, keep_dim)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    helper = LayerHelper("matmul")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul", inputs={"X": x, "Y": y}, outputs={"Out": out},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)})
    return out


def elementwise_op(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_pow", x, y, axis, act, name)


# ---------------------------------------------------------------------------
# tensor manipulation (``:685``, ``:719``, ``:760``)
# ---------------------------------------------------------------------------

def concat(input, axis=0, name=None):
    helper = LayerHelper("concat")
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def slice(input, axes, starts, ends):
    return _single_out("slice", input,
                       {"axes": list(axes), "starts": list(starts),
                        "ends": list(ends)}, in_slot="Input")


def one_hot(input, depth, dtype="float32"):
    return _single_out("one_hot", input, {"depth": depth, "dtype": dtype},
                       out_dtype=dtype)
