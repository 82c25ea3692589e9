"""LayerHelper: parameter creation and op appending used by every layer.

Counterpart of ``paddle_tpu/layers/helper.py``.
"""

from __future__ import annotations

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.framework import (default_main_program,
                                        default_startup_program)


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        if kwargs.get("name") is None:
            self.name = unique_name.generate(layer_type)
        else:
            self.name = kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(self.name + ".tmp"), dtype=dtype,
            shape=None, stop_gradient=stop_gradient)

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        """Adds the parameter to both the main and the startup global
        blocks and appends its initializer op to the startup program."""
        from paddle_tpu_torch.initializer import Constant, Xavier
        from paddle_tpu_torch.param_attr import ParamAttr

        attr = ParamAttr._to_attr(attr)
        suffix = "b" if is_bias else "w"
        name = attr.name or unique_name.generate(f"{self.name}.{suffix}")
        shape = [int(s) for s in shape]
        main_param = self.block.program.global_block().create_parameter(
            name, shape, dtype)
        main_param.stop_gradient = not attr.trainable
        main_param.trainable = attr.trainable
        # read by the optimizer, which refuses what it cannot honour
        main_param.regularizer = attr.regularizer
        init = (attr.initializer or default_initializer
                or (Constant(0.0) if is_bias else Xavier()))
        startup_block = self.startup_program.global_block()
        sv = startup_block.create_parameter(name, shape, dtype)
        sv.trainable = attr.trainable
        init(sv, startup_block)
        return main_param

    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    def append_activation(self, out_var, act):
        if act is None:
            return out_var
        act_out = self.create_variable_for_type_inference(out_var.dtype)
        self.block.append_op(type=act, inputs={"X": out_var},
                             outputs={"Out": act_out})
        return act_out
