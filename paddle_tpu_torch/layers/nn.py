"""Layer functions building the IR.

Counterpart of ``paddle_tpu/layers/nn.py``: the layers the Transformer LM
calls, emitting the same op types, slots and attrs as the JAX package.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.types import dtype_name
from paddle_tpu_torch.layers.helper import LayerHelper

__all__ = [
    "fc", "embedding", "layer_norm", "elementwise_add", "scale",
    "reshape", "transpose", "flash_attention", "mean",
    "softmax_with_cross_entropy", "relu", "gelu", "elementwise_mul", "cast",
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


def mean(x, name=None):
    return _single_out("mean", x)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_add")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="elementwise_add", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_mul")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="elementwise_mul", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def relu(x, name=None):
    return _single_out("relu", x)


def gelu(x, approximate=False, name=None):
    return _single_out("gelu", x, {"approximate": approximate})


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
    the IR for the JAX package and ignored by the port's kernel."""
    return _single_out(
        "flash_attention", q,
        {"causal": causal, "scale": float(scale or 0.0),
         "block_q": int(block_q or 0), "block_k": int(block_k or 0)},
        ins_extra={"K": k, "V": v}, in_slot="Q")
