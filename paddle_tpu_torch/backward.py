"""append_backward: autodiff as a program transformation.

Counterpart of ``paddle_tpu/backward.py`` (``:22-282``), op for op: the
loss seed ``fill_constant``, one ``<op>_grad`` per forward op that
carries a gradient, ``sum`` where a var fans out (with the ``@RENAME``
of a partial that holds the canonical name), ``fill_zeros_like`` for a
sibling output without a grad, ``assign`` to canonical ``@GRAD`` names,
and the same ``unique_name`` draws, so both packages append the same
program.  The grad ops' computes are synthesised by the registry
(``core/registry.py``).

Not ported yet: the ``checkpoints`` (recompute) branch, IR-level
``grad_maker`` ops and per-var ``error_clip``; ``checkpoints`` raises.
"""

from __future__ import annotations

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.core.program import BACKWARD, OpDesc
from paddle_tpu_torch.core.registry import (GRAD_SUFFIX, get_op_def,
                                            has_op_def)


def _grad_name(name: str, suffix: str = "") -> str:
    return name + GRAD_SUFFIX + suffix


def _needs_grad(block, name, no_grad_set):
    if name in no_grad_set:
        return False
    try:
        v = block.var(name)
    except KeyError:
        return False
    if v.stop_gradient:
        return False
    if v.dtype is not None and not any(
            v.dtype.startswith(p) for p in ("float", "bfloat", "complex")):
        return False
    return True


def _create_grad_var(block, fwd_name, grad_name):
    try:
        fv = block.var(fwd_name)
        shape, dtype = fv.shape, fv.dtype
    except KeyError:
        shape, dtype = None, "float32"
    if grad_name not in block.vars:
        block.create_var(name=grad_name, shape=shape, dtype=dtype,
                         stop_gradient=True)
    return block.vars[grad_name]


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Appends grad ops for every op contributing to ``loss``; returns
    ``[(param, grad_var)]`` for the trainable parameters."""
    if checkpoints:
        raise NotImplementedError(
            "append_backward: recompute checkpoints are not ported yet")
    block = loss.block
    program = block.program
    no_grad_set = set(no_grad_set or ())
    fwd_ops = list(block.ops)

    # seed: d loss / d loss = 1
    loss_grad = _grad_name(loss.name)
    _create_grad_var(block, loss.name, loss_grad)
    block.append_op(
        type="fill_constant", outputs={"Out": loss_grad},
        attrs={"shape": list(loss.shape or []), "dtype": loss.dtype,
               "value": 1.0},
        op_role=BACKWARD)

    # var -> partial-grad var names produced so far
    grad_map: dict = {loss.name: [loss_grad]}
    n_fwd = len(fwd_ops)

    def merged_grad(var_name):
        """The canonical grad var of ``var_name``, summing its partials
        when there are several."""
        parts = grad_map.get(var_name)
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]
        out = _grad_name(var_name)
        if out in parts:
            # the canonical name is one of the partials: rename it in the
            # ops appended since the boundary
            renamed = _grad_name(var_name, "@RENAME")
            block.vars[renamed] = block.vars.pop(out)
            block.vars[renamed].name = renamed
            for op in block.ops[n_fwd:]:
                for slot, names in list(op.outputs.items()):
                    op.outputs[slot] = [renamed if n == out else n
                                        for n in names]
                for slot, names in list(op.inputs.items()):
                    op.inputs[slot] = [renamed if n == out else n
                                       for n in names]
            parts = [renamed if p == out else p for p in parts]
        _create_grad_var(block, var_name, out)
        block.append_op(type="sum", inputs={"X": parts},
                        outputs={"Out": out}, op_role=BACKWARD,
                        infer_shape=False)
        grad_map[var_name] = [out]
        return out

    for op in reversed(fwd_ops):
        if not has_op_def(op.type):
            continue
        op_def = get_op_def(op.type)
        if not op_def.differentiable or op_def.host_only:
            continue
        if not any(n in grad_map for n in op.output_names()):
            continue
        grad_out_slots = {}
        for slot, names in op.outputs.items():
            if not any(n in grad_map for n in names):
                continue
            gnames = []
            for n in names:
                g = merged_grad(n)
                if g is None:
                    # sibling output without upstream grad: explicit
                    # zeros keep duplicable slots aligned
                    z = _grad_name(n, "@ZERO")
                    if z not in block.vars:
                        _create_grad_var(block, n, z)
                        block.append_op(
                            type="fill_zeros_like", inputs={"X": n},
                            outputs={"Out": z}, op_role=BACKWARD,
                            infer_shape=False)
                    g = z
                gnames.append(g)
            grad_out_slots[slot + GRAD_SUFFIX] = gnames

        grad_inputs = dict(grad_out_slots)
        for slot, names in op.inputs.items():
            grad_inputs[slot] = list(names)
        grad_outputs = {}
        for slot, names in op.inputs.items():
            if not any(_needs_grad(block, n, no_grad_set) for n in names):
                continue
            gnames = []
            for n in names:
                # one partial per occurrence: a var repeated within a
                # duplicable slot gets distinct names
                if n in grad_map or not _needs_grad(block, n, no_grad_set):
                    g = _grad_name(n, "@" + unique_name.generate("p"))
                else:
                    g = _grad_name(n)
                _create_grad_var(block, n, g)
                if _needs_grad(block, n, no_grad_set):
                    grad_map.setdefault(n, []).append(g)
                gnames.append(g)
            grad_outputs[slot + GRAD_SUFFIX] = gnames
        if not grad_outputs:
            continue
        block.ops.append(OpDesc(op.type + "_grad", grad_inputs,
                                grad_outputs, dict(op.attrs), BACKWARD,
                                stage=op.stage))

    params = (
        [program.global_block().var(p) if isinstance(p, str) else p
         for p in parameter_list]
        if parameter_list else program.all_parameters())
    params_grads = []

    def canonicalize(name):
        g = merged_grad(name)
        if g is None:
            return None
        if g != _grad_name(name):
            canonical = _grad_name(name)
            _create_grad_var(block, name, canonical)
            block.append_op(type="assign", inputs={"X": g},
                            outputs={"Out": canonical},
                            op_role=BACKWARD, infer_shape=False)
            g = canonical
        return g

    for p in params:
        if p.name in no_grad_set or not p.trainable:
            continue
        g = canonicalize(p.name)
        if g is not None:
            params_grads.append((p, block.var(g)))
    # feed leaves have no producing op: merge their partials here
    for name, v in list(block.vars.items()):
        if v.is_data and name in grad_map and name not in no_grad_set:
            canonicalize(name)
    return params_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grads of ``targets[0]`` with respect to ``inputs`` (grad vars, or
    None where an input gets none)."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if target_gradients is not None:
        raise NotImplementedError(
            "gradients: target_gradients are not supported")
    loss = targets[0]
    append_backward(loss, no_grad_set=no_grad_set)
    return [loss.block.vars.get(_grad_name(x.name)) for x in inputs]
