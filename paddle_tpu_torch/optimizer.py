"""Optimizers as IR transformations.

Counterpart of ``paddle_tpu/optimizer.py`` (``:21-154,204-271``):
``minimize`` runs ``append_backward`` and appends one update op per
parameter (``op_role`` optimize), reading persistable accumulators that
are created in both the main and the startup program.  Learning-rate
and accumulator names come from the same ``unique_name`` draws as the
JAX package's, so a checkpoint of persistables carries across.

``Adam(fuse=True)`` appends one ``fused_adam`` op over every parameter
instead of one ``adam`` op each.

Not ported yet, and refused rather than ignored: regularization and
``grad_clip``.  Not ported yet: a learning rate given as a scheduler's
variable, and the dygraph branch.
"""

from __future__ import annotations

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.core.program import OPTIMIZE
from paddle_tpu_torch.framework import default_startup_program


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        if regularization is not None:
            raise NotImplementedError(
                "optimizer regularization is not ported yet")
        self._learning_rate = learning_rate
        self._accumulators: dict = {}
        self._lr_var = None

    def _create_lr_var(self, block):
        if self._lr_var is not None:
            return self._lr_var
        name = unique_name.generate("learning_rate")
        self._lr_var = block.program.global_block().create_var(
            name=name, shape=[1], dtype="float32", persistable=True)
        sb = default_startup_program().global_block()
        sv = sb.create_var(name=name, shape=[1], dtype="float32",
                           persistable=True)
        sb.append_op(
            type="fill_constant", outputs={"Out": sv},
            attrs={"shape": [1], "dtype": "float32",
                   "value": float(self._learning_rate)})
        return self._lr_var

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        var_name = unique_name.generate(f"{param.name}_{name}")
        shape = shape if shape is not None else list(param.shape)
        dtype = dtype or param.dtype
        block = param.block.program.global_block()
        v = block.create_var(name=var_name, shape=shape, dtype=dtype,
                             persistable=True, stop_gradient=True)
        # a same-shaped accumulator shards as its parameter does (ZeRO's
        # optimizer state lives with the parameter's block); a [1]
        # accumulator keeps its own shape and stays replicated
        if getattr(param, "sharding", None) is not None and \
                list(shape) == list(param.shape or ()):
            v.set_sharding(param.sharding)
        sb = default_startup_program().global_block()
        sv = sb.create_var(name=var_name, shape=shape, dtype=dtype,
                           persistable=True)
        sb.append_op(
            type="fill_constant", outputs={"Out": sv},
            attrs={"shape": shape, "dtype": dtype,
                   "value": float(fill_value)})
        self._accumulators[key] = v
        return v

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    @staticmethod
    def _refuse_regularizers(params_grads):
        for p, _ in params_grads:
            if getattr(p, "regularizer", None) is not None:
                raise NotImplementedError(
                    f"parameter {p.name}: regularizers are not ported yet")

    def apply_gradients(self, params_grads):
        self._refuse_regularizers(params_grads)
        block = params_grads[0][0].block.program.global_block()
        self._create_lr_var(block)
        for p, g in params_grads:
            self._append_optimize_op(block, (p, g))
        return []

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        params_grads = self.backward(loss, startup_program,
                                     parameter_list, no_grad_set)
        self.apply_gradients(params_grads)
        return [], params_grads


class SGD(Optimizer):
    def _append_optimize_op(self, block, pg):
        p, g = pg
        block.append_op(
            type="sgd",
            inputs={"Param": p, "Grad": g, "LearningRate": self._lr_var},
            outputs={"ParamOut": p}, op_role=OPTIMIZE, infer_shape=False)


SGDOptimizer = SGD


class Momentum(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_optimize_op(self, block, pg):
        p, g = pg
        vel = self._add_accumulator("velocity", p)
        block.append_op(
            type="momentum",
            inputs={"Param": p, "Grad": g, "Velocity": vel,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "VelocityOut": vel},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov},
            op_role=OPTIMIZE, infer_shape=False)


MomentumOptimizer = Momentum


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, fuse=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode
        self._fuse = fuse

    def apply_gradients(self, params_grads):
        """With ``fuse``, one ``fused_adam`` op over every (param, grad).
        The moments are named param by param as in the unfused layout, so
        a checkpoint carries across; the beta pows are shared, anchored
        on the first parameter (``paddle_tpu/optimizer.py:218-248``)."""
        if not (self._fuse and params_grads):
            return super().apply_gradients(params_grads)
        self._refuse_regularizers(params_grads)
        block = params_grads[0][0].block.program.global_block()
        self._create_lr_var(block)
        ps = [p for p, _ in params_grads]
        gs = [g for _, g in params_grads]
        m1s = [self._add_accumulator("moment1", p) for p in ps]
        m2s = [self._add_accumulator("moment2", p) for p in ps]
        b1p = self._add_accumulator("beta1_pow", ps[0], self._beta1, [1])
        b2p = self._add_accumulator("beta2_pow", ps[0], self._beta2, [1])
        block.append_op(
            type="fused_adam",
            inputs={"Param": ps, "Grad": gs, "Moment1": m1s,
                    "Moment2": m2s, "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": ps, "Moment1Out": m1s,
                     "Moment2Out": m2s, "Beta1PowOut": b1p,
                     "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
            op_role=OPTIMIZE, infer_shape=False)
        return []

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow", p, self._beta1, [1])
        b2p = self._add_accumulator("beta2_pow", p, self._beta2, [1])
        block.append_op(
            type="adam",
            inputs={"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "lazy_mode": self._lazy_mode},
            op_role=OPTIMIZE, infer_shape=False)


AdamOptimizer = Adam
