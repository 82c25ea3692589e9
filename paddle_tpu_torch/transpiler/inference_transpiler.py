"""Inference passes over the Program IR.

Counterpart of ``paddle_tpu/transpiler/inference_transpiler.py``
(``:50-321``): ``InferenceTranspiler`` (conv2d [+ bias add] + test-mode
batch_norm -> conv2d with the statistics folded into its filter, plus a
bias add), ``FuseFCTranspiler`` (mul + bias add [+ act] -> ``fc``) and
``FuseElewiseAddActTranspiler`` (elementwise_add + act ->
``fused_elemwise_activation``), with the same guards, so both packages
rewrite a program into the same op list.  The fold also rewrites the
filter and bias values in the scope, computed in numpy in f32 as the
JAX package computes them; the two fusions are pure IR rewrites.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.program import OpDesc
from paddle_tpu_torch.core.types import from_numpy, to_numpy


def _fresh_name(block, key):
    """The first ``key_0``, ``key_1``, ... that the block does not hold:
    a name that depends on the program alone, so one saved model loads
    as one program, and never one a saved fusing pass already drew."""
    n = 0
    while block.has_var(f"{key}_{n}"):
        n += 1
    return f"{key}_{n}"


def _producer(block, name, before_idx):
    """(index, op) of the last op writing ``name`` before before_idx,
    else (None, None)."""
    for j in range(before_idx - 1, -1, -1):
        op = block.ops[j]
        if any(name in names for names in op.outputs.values()):
            return j, op
    return None, None


def _consumers(block, name):
    count = 0
    for op in block.ops:
        for names in op.inputs.values():
            count += names.count(name)
    return count


def _first_consumer(block, name, after_idx):
    """(index, op) of the first op reading ``name`` after after_idx."""
    for j in range(after_idx + 1, len(block.ops)):
        op = block.ops[j]
        if any(name in names for names in op.inputs.values()):
            return j, op
    return -1, None


class InferenceTranspiler:
    """Folds each test-mode ``batch_norm`` into the ``conv2d`` before it
    (directly, or through a per-channel bias add):
    ``W' = W * gamma / sqrt(var + eps)`` per output channel, and the bias
    ``(b - mean) * gamma / sqrt(var + eps) + beta`` (``b`` 0 without a
    bias add, which is then appended).

    Guards, as the JAX pass: the bias add's Y is a 1-D persistable on
    axis 1 (a residual add is never folded); the conv output and the bn
    input each feed one op; the bn input is not in ``protected`` (the
    fold erases it); the filter is a scope-resident parameter."""

    def transpile(self, program, place=None, scope=None, protected=None):
        """Folds every qualifying chain of ``program``; mutates it and the
        scope's filter and bias values.  ``place`` is accepted for the
        reference signature and unused."""
        from paddle_tpu_torch.core.scope import global_scope

        scope = scope or global_scope()
        protected = frozenset(protected or ())
        block = program.global_block()
        while self._fuse_one(block, scope, protected):
            pass
        return program

    def _fuse_one(self, block, scope, protected):
        for i, op in enumerate(block.ops):
            if op.type != "batch_norm" or not op.attrs.get("is_test"):
                continue
            x_name = op.inputs["X"][0]
            j, prev = _producer(block, x_name, i)
            if prev is None:
                continue
            bias_op = None
            if prev.type == "elementwise_add":
                y_in = prev.inputs["Y"][0]
                try:
                    y_var = block.var(y_in)
                except KeyError:
                    continue
                if (not y_var.persistable or y_var.shape is None
                        or len(y_var.shape) != 1
                        or prev.attrs.get("axis", -1) != 1):
                    continue
                _, conv = _producer(block, prev.inputs["X"][0], j)
                if conv is None or conv.type != "conv2d":
                    continue
                if _consumers(block, prev.inputs["X"][0]) != 1:
                    continue
                bias_op = prev
            elif prev.type == "conv2d":
                conv = prev
            else:
                continue
            if _consumers(block, x_name) != 1 or x_name in protected:
                continue
            if scope.find_var(conv.inputs["Filter"][0]) is None:
                continue
            y_name = op.outputs["Y"][0]
            self._fold(block, scope, conv, bias_op, op, x_name, y_name)
            if bias_op is not None:
                # the bias add becomes the chain's tail, writing bn's output
                for slot, names in bias_op.outputs.items():
                    bias_op.outputs[slot] = [y_name if n == x_name else n
                                             for n in names]
            block.ops.remove(op)
            return True
        return False

    @staticmethod
    def _fold(block, scope, conv, bias_op, bn, x_name, y_name):
        eps = bn.attrs.get("epsilon", 1e-5)

        def get(name):
            return to_numpy(scope.find_var(name).get(), name)

        def put(name, value):
            device = scope.find_var(name).get().device
            scope.var(name).set(from_numpy(value, name).to(device))

        gamma = get(bn.inputs["Scale"][0])
        beta = get(bn.inputs["Bias"][0])
        mean = get(bn.inputs["Mean"][0])
        var = get(bn.inputs["Variance"][0])
        factor = gamma / np.sqrt(var + eps)          # [C_out]
        w_name = conv.inputs["Filter"][0]
        put(w_name, get(w_name) * factor[:, None, None, None])
        if bias_op is not None:
            b_name = bias_op.inputs["Y"][0]
            put(b_name, (get(b_name) - mean) * factor + beta)
            return
        # a new bias var and an elementwise_add writing bn's output
        b_name = _fresh_name(block, w_name + ".bn_folded_bias")
        block.create_var(name=b_name, shape=beta.shape,
                         dtype=str(beta.dtype), persistable=True)
        device = scope.find_var(w_name).get().device
        scope.var(b_name).set(from_numpy(beta - mean * factor,
                                         b_name).to(device))
        add = OpDesc("elementwise_add", {"X": [x_name], "Y": [b_name]},
                     {"Out": [y_name]}, {"axis": 1})
        block.ops.insert(block.ops.index(conv) + 1, add)


class FuseFCTranspiler:
    """mul + elementwise_add -> fc, folding a following activation into
    the fc op's ``activation_type`` when it is the add's only consumer.

    Guards (the fc op assumes a 2-D W and a trailing column bias): mul
    has y_num_col_dims == 1 and a rank-2 W; the add is a trailing-axis
    bias (axis -1 or 1) of W's output width."""

    _ACTS = ("relu", "tanh", "sigmoid")

    def transpile(self, program, protected=None):
        protected = frozenset(protected or ())
        block = program.global_block()
        while self._fuse_one(block, protected):
            pass
        return program

    def _fuse_one(self, block, protected):
        for i, op in enumerate(block.ops):
            if op.type != "mul" or op.attrs.get("y_num_col_dims", 1) != 1:
                continue
            try:
                w_var = block.var(op.inputs["Y"][0])
            except KeyError:
                continue
            if w_var.shape is None or len(w_var.shape) != 2:
                continue
            out = op.outputs["Out"][0]
            if _consumers(block, out) != 1 or out in protected:
                continue  # fusing erases the mul output
            j, add_op = _first_consumer(block, out, i)
            if add_op is None or add_op.type != "elementwise_add" or \
                    add_op.inputs["X"][0] != out:
                continue
            if add_op.attrs.get("axis", -1) not in (-1, 1):
                continue  # only a trailing column bias maps onto fc
            bias = add_op.inputs["Y"][0]
            try:
                bias_var = block.var(bias)
            except KeyError:
                continue
            if not bias_var.persistable or bias_var.shape is None or \
                    len(bias_var.shape) != 1 or \
                    int(bias_var.shape[0]) != int(w_var.shape[1]):
                continue
            add_out = add_op.outputs["Out"][0]
            act_op = None
            _, cand = _first_consumer(block, add_out, j)
            if cand is not None and cand.type in self._ACTS and \
                    _consumers(block, add_out) == 1 and \
                    add_out not in protected:
                act_op = cand
            final_out = act_op.outputs["Out"][0] if act_op else add_out
            block.ops[i] = OpDesc(
                "fc",
                {"Input": list(op.inputs["X"]), "W": list(op.inputs["Y"]),
                 "Bias": [bias]},
                {"Out": [final_out]},
                {"in_num_col_dims": op.attrs.get("x_num_col_dims", 1),
                 "activation_type": act_op.type if act_op else ""},
                op.op_role)
            block.ops.remove(add_op)
            if act_op is not None:
                block.ops.remove(act_op)
            return True
        return False


class FuseElewiseAddActTranspiler:
    """elementwise_add + activation -> fused_elemwise_activation.

    Guards: only attr-free activations (relu/tanh/sigmoid), and only
    trailing (numpy-style) broadcasts, since the fused op ignores its
    axis attr."""

    _ACTS = ("relu", "tanh", "sigmoid")

    def transpile(self, program, protected=None):
        protected = frozenset(protected or ())
        block = program.global_block()
        while self._fuse_one(block, protected):
            pass
        return program

    @staticmethod
    def _trailing_broadcast(block, add_op):
        try:
            x_var = block.var(add_op.inputs["X"][0])
            y_var = block.var(add_op.inputs["Y"][0])
        except KeyError:
            return False
        if x_var.shape is None or y_var.shape is None:
            return False
        xr, yr = len(x_var.shape), len(y_var.shape)
        return xr == yr or add_op.attrs.get("axis", -1) in (-1, xr - yr)

    def _fuse_one(self, block, protected):
        for i, op in enumerate(block.ops):
            if op.type != "elementwise_add" or \
                    not self._trailing_broadcast(block, op):
                continue
            out = op.outputs["Out"][0]
            if _consumers(block, out) != 1 or out in protected:
                continue  # fusing erases the add output
            _, act_op = _first_consumer(block, out, i)
            if act_op is None or act_op.type not in self._ACTS:
                continue
            inter = block.create_var(
                name=_fresh_name(block, "fuse_add_act.inter"),
                shape=None, dtype=None)
            block.ops[i] = OpDesc(
                "fused_elemwise_activation",
                {"X": list(op.inputs["X"]), "Y": list(op.inputs["Y"])},
                {"Out": list(act_op.outputs["Out"]),
                 "IntermediateOut": [inter.name]},
                {"functor_list": [act_op.type, "elementwise_add"],
                 "axis": op.attrs.get("axis", -1), "scale": 1.0,
                 "save_intermediate_out": False}, op.op_role)
            block.ops.remove(act_op)
            return True
        return False
