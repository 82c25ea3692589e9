"""OptimizerWithMixedPrecision: the bf16 rewrite plus loss scaling.

Counterpart of ``paddle_tpu/contrib/mixed_precision/decorator.py``,
appending the same ops and vars under the same ``unique_name`` draws:
``minimize`` rewrites the program to bf16 (``rewrite_program``), scales
the loss, runs the wrapped optimizer's backward, unscales the grads with
a finiteness check (``check_finite_and_unscale``, which zeroes them on
an overflow) and, with dynamic scaling, updates the scale
(``update_loss_scaling``).  Master weights stay f32.
"""

from __future__ import annotations

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.contrib.mixed_precision.fp16_lists import \
    AutoMixedPrecisionLists
from paddle_tpu_torch.contrib.mixed_precision.fp16_utils import \
    rewrite_program
from paddle_tpu_torch.core.program import OPTIMIZE
from paddle_tpu_torch.framework import default_startup_program


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                 dest_dtype="bfloat16"):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dest_dtype = dest_dtype
        self._loss_scaling = None
        self._found_inf = None

    def get_loss_scaling(self):
        """The persistable loss-scaling var (fetchable)."""
        return self._loss_scaling

    def _create_scaling_vars(self, block):
        def persist(name, dtype, value):
            v = block.create_var(name=name, shape=[1], dtype=dtype,
                                 persistable=True, stop_gradient=True)
            sb = default_startup_program().global_block()
            sv = sb.create_var(name=name, shape=[1], dtype=dtype,
                               persistable=True)
            sb.append_op(type="fill_constant", outputs={"Out": sv},
                         attrs={"shape": [1], "dtype": dtype,
                                "value": float(value)})
            return v

        self._loss_scaling = persist(
            unique_name.generate("loss_scaling"), "float32",
            self._init_loss_scaling)
        if self._use_dynamic_loss_scaling:
            self._good_steps = persist(
                unique_name.generate("good_steps"), "int32", 0)
            self._bad_steps = persist(
                unique_name.generate("bad_steps"), "int32", 0)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Rewrite to low precision, scale the loss, run backward, unscale
        and check the grads.  Returns ``[(param, grad)]``."""
        program = loss.block.program
        rewrite_program(program, self._amp_lists, self._dest_dtype)
        block = program.global_block()
        self._create_scaling_vars(block)

        scaled_loss = block.create_var(
            name=unique_name.generate("scaled_loss"), dtype="float32",
            shape=[1])
        block.append_op(
            type="elementwise_mul",
            inputs={"X": loss, "Y": self._loss_scaling},
            outputs={"Out": scaled_loss}, attrs={"axis": -1})

        params_grads = self._optimizer.backward(
            scaled_loss, startup_program, parameter_list, no_grad_set)

        grads = [g for _, g in params_grads]
        self._found_inf = block.create_var(
            name=unique_name.generate("found_inf"), dtype="bool",
            shape=[1], stop_gradient=True)
        block.append_op(
            type="check_finite_and_unscale",
            inputs={"X": grads, "Scale": self._loss_scaling},
            outputs={"Out": grads, "FoundInfinite": self._found_inf},
            op_role=OPTIMIZE, infer_shape=False)
        if self._use_dynamic_loss_scaling:
            block.append_op(
                type="update_loss_scaling",
                inputs={"FoundInfinite": self._found_inf,
                        "PrevLossScaling": self._loss_scaling,
                        "InGoodSteps": self._good_steps,
                        "InBadSteps": self._bad_steps},
                outputs={"LossScaling": self._loss_scaling,
                         "OutGoodSteps": self._good_steps,
                         "OutBadSteps": self._bad_steps},
                attrs={"incr_every_n_steps": self._incr_every_n_steps,
                       "decr_every_n_nan_or_inf":
                           self._decr_every_n_nan_or_inf,
                       "incr_ratio": self._incr_ratio,
                       "decr_ratio": self._decr_ratio},
                op_role=OPTIMIZE, infer_shape=False)
        return params_grads

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        params_grads = self.backward(loss, startup_program,
                                     parameter_list, no_grad_set)
        self.apply_gradients(params_grads)
        return [], params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, dest_dtype="bfloat16"):
    """Wraps ``optimizer`` for bf16 training with loss scaling."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio,
        decr_ratio, dest_dtype)
