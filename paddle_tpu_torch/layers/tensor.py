"""Tensor-creation layers (counterpart of ``paddle_tpu/layers/tensor.py``)."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.layers.helper import LayerHelper

__all__ = ["assign", "fill_constant"]


def assign(input, output=None):
    """A constant ndarray as a program variable (``assign_value`` op)."""
    if not isinstance(input, np.ndarray):
        raise TypeError(
            f"assign takes a numpy array, got {type(input).__name__}")
    helper = LayerHelper("assign")
    output = output or helper.create_variable_for_type_inference(
        str(input.dtype))
    helper.append_op(type="assign_value", outputs={"Out": output},
                     attrs={"values": input, "dtype": str(input.dtype)})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    """A constant of ``shape`` (``fill_constant`` op); no gradient flows
    into it."""
    helper = LayerHelper("fill_constant")
    out = out or helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant", outputs={"Out": out},
        attrs={"shape": list(shape), "dtype": str(np.dtype(dtype)),
               "value": float(value)})
    out.stop_gradient = True
    return out
