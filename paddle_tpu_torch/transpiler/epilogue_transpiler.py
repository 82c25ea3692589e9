"""The epilogue-fusion pass.

Counterpart of ``paddle_tpu/transpiler/epilogue_transpiler.py``: the same
walk and guards, so both packages rewrite a program into the same op
list.  Each anchor collapses a producer and its sole-consumed tail into
one fused op carrying the matched stages in its ``epilogue`` attr
(``ops/epilogue.py``):

- ``conv``: conv2d (+ channel bias add) (+ same-shape residual add)
  (+ relu) -> ``conv2d_epilogue``;
- ``conv_bn``: conv2d (+ channel bias add) + train-mode batch_norm
  (+ residual add) (+ relu) -> ``conv2d_bn_train``, which keeps the
  batch_norm's MeanOut/VarianceOut/SavedMean/SavedVariance outputs;
- ``fc``: mul (+ bias) (+ residual) (+ relu or gelu) -> ``fc_epilogue``.

Every fused intermediate is sole-consumed and unprotected; conv anchors
take only group-1, undilated convs.  ``fuse_conv_epilogue`` and
``fuse_conv_bn_train`` run the pass with one conv anchor, as the JAX
package's wrappers do.  ``fold_int8_interlayer`` is the grammar's
requantize arm, the int8 interlayer fold that
``contrib.slim.quantization.convert_to_int8_execution`` runs.  The JAX
package's IR verifier around the pass (``checked_pass``) is not ported.

Run it before ``nhwc_transpile`` and before ``minimize``, so the backward
derives from the fused ops.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.program import OpDesc
from paddle_tpu_torch.ops.epilogue import spec_attr
from paddle_tpu_torch.transpiler.inference_transpiler import (
    _consumers, _first_consumer)

# anchor name -> the activation stages its kernel implements
_ANCHOR_ACTS = {"conv": ("relu",), "conv_bn": ("relu",),
                "fc": ("relu", "gelu")}


class EpilogueFusionTranspiler:
    ANCHORS = ("conv", "conv_bn", "fc")

    def transpile(self, program, protected=None, anchors=ANCHORS):
        """Fuses every chain of the given anchors in place, the first
        anchor's first chain each round; returns the number of chains
        fused."""
        for anchor in anchors:
            if anchor not in _ANCHOR_ACTS:
                raise ValueError(f"unknown epilogue anchor {anchor!r}")
        self._protected = frozenset(protected or ())
        block = program.global_block()
        fuse = {"conv": self._fuse_one_conv,
                "conv_bn": self._fuse_one_conv_bn,
                "fc": self._fuse_one_fc}
        n = 0
        while any(fuse[a](block) for a in anchors):
            n += 1
        return n

    def _sole_consumer(self, block, name, idx):
        """(index, op) of the single consumer of ``name`` after idx, or
        (None, None) when it has others or is protected."""
        if _consumers(block, name) != 1 or name in self._protected:
            return None, None
        return _first_consumer(block, name, idx)

    @staticmethod
    def _match_bias(block, nxt, cur, cout, axes_ok):
        """The bias var name when ``nxt`` adds a 1-D persistable [cout]
        var Y to ``cur`` on the channel axis, else None."""
        if nxt is None or nxt.type != "elementwise_add" or \
                nxt.inputs["X"][0] != cur:
            return None
        y = nxt.inputs["Y"][0]
        try:
            y_var = block.var(y)
        except KeyError:
            return None
        if nxt.attrs.get("axis", -1) not in axes_ok:
            return None
        if (y_var.persistable and y_var.shape is not None
                and len(y_var.shape) == 1
                and int(y_var.shape[0]) == int(cout)):
            return y
        return None

    @staticmethod
    def _match_residual(block, nxt, cur, out_shape):
        """The other operand's name when ``nxt`` adds a var of exactly
        ``out_shape`` to ``cur`` (either slot), else None."""
        if nxt is None or nxt.type != "elementwise_add" or \
                out_shape is None:
            return None
        xs, ys = nxt.inputs["X"][0], nxt.inputs["Y"][0]
        other = ys if xs == cur else xs if ys == cur else None
        if other is None:
            return None
        try:
            o_var = block.var(other)
        except KeyError:
            return None
        if o_var.shape is not None and \
                tuple(o_var.shape) == tuple(out_shape):
            return other
        return None

    @staticmethod
    def _conv_anchor(block, op):
        """(output var, channel count, bias axes) of a group-1, undilated
        4-D conv2d, else None."""
        a = op.attrs
        if op.type != "conv2d" or a.get("groups", 1) != 1 or \
                list(a.get("dilations", [1, 1])) != [1, 1]:
            return None
        out_var = block.var(op.outputs["Output"][0])
        if out_var.shape is None or len(out_var.shape) != 4:
            return None
        nchw = a.get("data_format", "NCHW") == "NCHW"
        return (out_var, out_var.shape[1 if nchw else -1],
                (1,) if nchw else (-1, 3))

    @staticmethod
    def _conv_attrs(op, **extra):
        a = op.attrs
        return {"strides": list(a.get("strides", [1, 1])),
                "paddings": list(a.get("paddings", [0, 0])),
                "groups": 1, **extra,
                "data_format": a.get("data_format", "NCHW")}

    def _fuse_one_conv(self, block):
        for i, op in enumerate(block.ops):
            anchor = self._conv_anchor(block, op)
            if anchor is None:
                continue
            out_var, cout, bias_axes = anchor
            consumed = []
            act = ""
            cur, j = out_var.name, i

            nj, nxt = self._sole_consumer(block, cur, j)
            bias_name = self._match_bias(block, nxt, cur, cout, bias_axes)
            if bias_name is not None:
                consumed.append(nxt)
                cur, j = nxt.outputs["Out"][0], nj
                nj, nxt = self._sole_consumer(block, cur, j)
            res_name = self._match_residual(block, nxt, cur, out_var.shape)
            if res_name is not None:
                consumed.append(nxt)
                cur, j = nxt.outputs["Out"][0], nj
                nj, nxt = self._sole_consumer(block, cur, j)
            if nxt is not None and nxt.type in _ANCHOR_ACTS["conv"]:
                act = nxt.type
                consumed.append(nxt)
                cur = nxt.outputs["Out"][0]
            if not consumed:
                continue

            inputs = {"Input": list(op.inputs["Input"]),
                      "Filter": list(op.inputs["Filter"])}
            if bias_name is not None:
                inputs["Bias"] = [bias_name]
            if res_name is not None:
                inputs["Residual"] = [res_name]
            fused = OpDesc(
                "conv2d_epilogue", inputs, {"Output": [cur]},
                self._conv_attrs(
                    op, act=act,
                    epilogue=spec_attr(bias=bias_name is not None,
                                       residual=res_name is not None,
                                       act=act)),
                op.op_role)
            self._splice(block, op, consumed, fused)
            return True
        return False

    def _fuse_one_conv_bn(self, block):
        for i, op in enumerate(block.ops):
            anchor = self._conv_anchor(block, op)
            if anchor is None:
                continue
            out_var, cout, bias_axes = anchor
            fmt = op.attrs.get("data_format", "NCHW")
            consumed = []
            cur, j = out_var.name, i

            nj, nxt = self._sole_consumer(block, cur, j)
            bias_name = self._match_bias(block, nxt, cur, cout, bias_axes)
            if bias_name is not None:
                consumed.append(nxt)
                cur, j = nxt.outputs["Out"][0], nj
                nj, nxt = self._sole_consumer(block, cur, j)
            # the anchor: a train-mode batch_norm of the conv, in its
            # layout, computing its own statistics
            if nxt is None or nxt.type != "batch_norm" or \
                    nxt.inputs["X"][0] != cur:
                continue
            bn = nxt
            ba = bn.attrs
            if ba.get("is_test", False) or \
                    ba.get("use_global_stats", False) or \
                    ba.get("data_layout", "NCHW") != fmt or \
                    "BatchMean" in bn.inputs or "BatchVariance" in bn.inputs:
                continue
            scale_v = block.var(bn.inputs["Scale"][0])
            if scale_v.shape is None or len(scale_v.shape) != 1 or \
                    int(scale_v.shape[0]) != int(cout):
                continue
            bn_y = bn.outputs["Y"][0]
            consumed.append(bn)
            cur, j = bn_y, nj
            nj, nxt = self._sole_consumer(block, cur, j)

            act = ""
            res_name = self._match_residual(block, nxt, cur,
                                            block.var(bn_y).shape)
            if res_name is not None:
                consumed.append(nxt)
                cur, j = nxt.outputs["Out"][0], nj
                nj, nxt = self._sole_consumer(block, cur, j)
            if nxt is not None and nxt.type in _ANCHOR_ACTS["conv_bn"]:
                act = nxt.type
                consumed.append(nxt)
                cur = nxt.outputs["Out"][0]

            inputs = {"Input": list(op.inputs["Input"]),
                      "Filter": list(op.inputs["Filter"]),
                      "Scale": list(bn.inputs["Scale"]),
                      "BNBias": list(bn.inputs["Bias"]),
                      "Mean": list(bn.inputs["Mean"]),
                      "Variance": list(bn.inputs["Variance"])}
            if bias_name is not None:
                inputs["Bias"] = [bias_name]
            if res_name is not None:
                inputs["Residual"] = [res_name]
            outputs = {"Output": [cur]}
            for slot in ("MeanOut", "VarianceOut", "SavedMean",
                         "SavedVariance"):
                outputs[slot] = list(bn.outputs[slot])
            fused = OpDesc(
                "conv2d_bn_train", inputs, outputs,
                self._conv_attrs(
                    op, act=act, epsilon=ba.get("epsilon", 1e-5),
                    momentum=ba.get("momentum", 0.9),
                    epilogue=spec_attr(bias=bias_name is not None,
                                       stats_tap=True, bn_apply=True,
                                       residual=res_name is not None,
                                       act=act)),
                op.op_role)
            self._splice(block, op, consumed, fused)
            return True
        return False

    def _fuse_one_fc(self, block):
        for i, op in enumerate(block.ops):
            if op.type != "mul":
                continue
            a = op.attrs
            xnc = a.get("x_num_col_dims", 1)
            if a.get("y_num_col_dims", 1) != 1:
                continue
            out = op.outputs["Out"][0]
            try:
                out_var = block.var(out)
                w_var = block.var(op.inputs["Y"][0])
            except KeyError:
                continue
            if out_var.shape is None or w_var.shape is None or \
                    len(w_var.shape) != 2:
                continue
            n_out = int(w_var.shape[1])
            # the fc bias rides on axis num_flatten_dims, the output's
            # last axis, so -1 is the same broadcast
            bias_axes = (xnc, -1)

            consumed = []
            act = ""
            approx = False
            cur, j = out, i

            nj, nxt = self._sole_consumer(block, cur, j)
            bias_name = self._match_bias(block, nxt, cur, n_out, bias_axes)
            if bias_name is not None:
                consumed.append(nxt)
                cur, j = nxt.outputs["Out"][0], nj
                nj, nxt = self._sole_consumer(block, cur, j)
            res_name = self._match_residual(block, nxt, cur, out_var.shape)
            if res_name is not None:
                consumed.append(nxt)
                cur, j = nxt.outputs["Out"][0], nj
                nj, nxt = self._sole_consumer(block, cur, j)
            if nxt is not None and nxt.type in _ANCHOR_ACTS["fc"]:
                act = nxt.type
                approx = bool(nxt.attrs.get("approximate", False))
                consumed.append(nxt)
                cur = nxt.outputs["Out"][0]
            if not consumed:
                continue

            inputs = {"X": list(op.inputs["X"]), "Y": list(op.inputs["Y"])}
            if bias_name is not None:
                inputs["Bias"] = [bias_name]
            if res_name is not None:
                inputs["Residual"] = [res_name]
            fused = OpDesc(
                "fc_epilogue", inputs, {"Out": [cur]},
                {"x_num_col_dims": xnc, "y_num_col_dims": 1,
                 "act": act, "approximate": approx,
                 "epilogue": spec_attr(bias=bias_name is not None,
                                       residual=res_name is not None,
                                       act=act)},
                op.op_role)
            self._splice(block, op, consumed, fused)
            return True
        return False

    @staticmethod
    def _splice(block, anchor_op, consumed, fused):
        """Puts the fused op where the chain's tail was and erases the
        anchor and the chain.  Sinking the anchor to the tail is safe:
        every erased intermediate is consumed only inside the chain, and
        the residual may be produced between the anchor and the tail."""
        block.ops[block.ops.index(consumed[-1])] = fused
        block.ops.remove(anchor_op)
        for c in consumed[:-1]:
            block.ops.remove(c)


def fuse_epilogue(program, protected=None,
                  anchors=EpilogueFusionTranspiler.ANCHORS):
    """Fuses every epilogue chain of ``program`` in place, over the given
    anchors; returns the number of chains fused."""
    return EpilogueFusionTranspiler().transpile(program, protected=protected,
                                                anchors=anchors)


def fuse_conv_epilogue(program, protected=None):
    """Fuses every conv (+bias) (+residual) (+relu) chain of ``program``
    onto ``conv2d_epilogue``, in place; returns the number fused."""
    return fuse_epilogue(program, protected=protected, anchors=("conv",))


def fuse_conv_bn_train(program, protected=None):
    """Fuses every conv (+bias) + train-mode batch_norm (+residual)
    (+relu) chain of ``program`` onto ``conv2d_bn_train``, in place;
    returns the number fused."""
    return fuse_epilogue(program, protected=protected, anchors=("conv_bn",))


# ---------------------------------------------------------------------------
# int8 interlayer fold: the requantize arm of the grammar
# ---------------------------------------------------------------------------

def fold_int8_interlayer(program, block, out_dtype, weight_bits,
                         protected):
    """Folds quantized-op -> quantized-op edges so the tensor between the
    layers is int8 (``paddle_tpu/transpiler/epilogue_transpiler.py:407``,
    walk for walk).

    For each ``conv2d_int8`` producer with a calibrated InScale, its
    epilogue chain: an optional per-channel bias ``elementwise_add`` (a 1-D
    persistable Y), an optional same-shape float residual add, then an
    optional ``relu``, each link sole-consumed and unprotected.  If every
    consumer of the chain's tail is an int8 op reading it as its
    activation with a calibrated InScale on that tensor, the full fold
    puts Bias, Residual, fuse_relu and OutScale on the producer, deletes
    the chain and makes the tail int8; otherwise the partial fold absorbs
    the chain and keeps the float output.  The matched stages go on the
    producer's ``epilogue`` attr.  Returns the fold statistics
    (n_producers, n_edges_folded, n_partial_folds, n_rejected,
    n_residual_folds, n_int8_inputs)."""
    del out_dtype, weight_bits  # the epilogue reuses the producer's

    sub_read = set()
    for blk in program.blocks:
        if blk is block:
            continue
        for op in blk.ops:
            for names in op.inputs.values():
                sub_read.update(names)

    def _build_consumers():
        consumers = {}
        for op in block.ops:
            for slot, names in op.inputs.items():
                for n in names:
                    consumers.setdefault(n, []).append((op, slot))
        return consumers

    def _is_bias_add(op):
        if op.type != "elementwise_add":
            return False
        v = block.vars.get(op.inputs.get("Y", [None])[0])
        return (v is not None and v.persistable and v.shape is not None
                and len(v.shape) == 1)

    def _residual_operand(op, cur):
        """The same-shape float skip operand of elementwise_add ``op``
        (either slot), or None; an int8 operand (a folded edge's tensor)
        cannot join a float add."""
        if op.type != "elementwise_add" or _is_bias_add(op):
            return None
        xs, ys = op.inputs["X"][0], op.inputs["Y"][0]
        other = ys if xs == cur else xs if ys == cur else None
        if other is None:
            return None
        ov, tv = block.vars.get(other), block.vars.get(cur)
        if (ov is None or tv is None or ov.shape is None
                or tv.shape is None
                or tuple(ov.shape) != tuple(tv.shape)
                or str(ov.dtype) == "int8"):
            return None
        return other

    def _quantized_consumer(op, slot, tail):
        """Whether (op, slot) is an int8 op reading ``tail`` as its
        activation with a calibrated InScale on that tensor."""
        if op.inputs.get("InScale", [None])[0] != tail + "@ACT_SCALE":
            return False
        if op.type == "conv2d_int8":
            return slot == "Input"
        if op.type == "mul_int8":
            if slot != "X":
                return False
            sv = block.vars.get(op.inputs["Scale"][0])
            if sv is None or sv.shape is None:
                return False
            shp = tuple(sv.shape)
            # per-input-row scales fold into the activation before its
            # quantisation: refused, as mul_int8 refuses them at run time
            if len(shp) >= 2 and int(np.prod(shp[1:])) == 1 and \
                    shp[0] != 1:
                return False
            yv = block.vars.get(op.inputs["Y"][0])
            k = yv.shape[0] if yv is not None and yv.shape else None
            return not (len(shp) == 1 and shp[0] == k and shp[0] != 1)
        return False

    def _open(name, cons):
        """Whether the chain may take the sole consumer of ``name``."""
        return len(cons) == 1 and name not in sub_read and \
            name not in protected

    stats = {"n_producers": 0, "n_edges_folded": 0,
             "n_partial_folds": 0, "n_rejected": 0,
             "n_residual_folds": 0}
    n_int8_in = 0
    done = set()
    while True:
        # a residual fold moves a second producer's tail (the skip operand
        # moves onto the fused op's Residual slot): rebuild each round
        consumers = _build_consumers()
        P = next((op for op in block.ops
                  if op.type == "conv2d_int8" and id(op) not in done
                  and op.inputs.get("InScale")), None)
        if P is None:
            break
        done.add(id(P))
        if P.attrs.get("out_dtype") == "int32" or \
                P.inputs.get("OutScale"):
            continue
        stats["n_producers"] += 1
        chain = []
        bias_op = res_op = relu_op = None
        res_name = None
        cur = P.outputs["Output"][0]
        cons = consumers.get(cur, [])
        if _open(cur, cons) and _is_bias_add(cons[0][0]) and \
                cons[0][1] == "X":
            bias_op = cons[0][0]
            chain.append(bias_op)
            cur = bias_op.outputs["Out"][0]
            cons = consumers.get(cur, [])
        if _open(cur, cons):
            rn = _residual_operand(cons[0][0], cur)
            if rn is not None:
                res_op, res_name = cons[0][0], rn
                chain.append(res_op)
                cur = res_op.outputs["Out"][0]
                cons = consumers.get(cur, [])
        if _open(cur, cons) and cons[0][0].type == "relu":
            relu_op = cons[0][0]
            chain.append(relu_op)
            cur = relu_op.outputs["Out"][0]
            cons = consumers.get(cur, [])
        tail = cur
        if not chain and not cons:
            continue
        full = (bool(cons)
                and all(_quantized_consumer(op, slot, tail)
                        for op, slot in cons)
                and tail not in protected and tail not in sub_read
                and (tail + "@ACT_SCALE") in block.vars)
        if not full and not chain:
            stats["n_rejected"] += 1
            continue
        if bias_op is not None:
            P.inputs["Bias"] = list(bias_op.inputs["Y"])
            P.set_attr("bias_axis", bias_op.attrs.get("axis", -1))
        if res_op is not None:
            P.inputs["Residual"] = [res_name]
            stats["n_residual_folds"] += 1
        P.set_attr("fuse_relu", relu_op is not None)
        P.set_attr("epilogue", spec_attr(
            bias=bias_op is not None, residual=res_op is not None,
            act="relu" if relu_op is not None else "", requantize=full))
        if chain:
            P.outputs["Output"] = [tail]
            if res_op is not None:
                # the skip operand may be produced between P and the
                # residual add: P moves to the chain's tail position
                i_p = block.ops.index(P)
                block.ops[block.ops.index(chain[-1])] = P
                del block.ops[i_p]
            block.ops = [o for o in block.ops if o not in chain]
        if full:
            P.inputs["OutScale"] = [tail + "@ACT_SCALE"]
            tv = block.vars.get(tail)
            if tv is not None:
                tv.dtype = "int8"
            n_int8_in += len(cons)
            stats["n_edges_folded"] += 1
        else:
            stats["n_partial_folds"] += 1
    stats["n_int8_inputs"] = n_int8_in
    return stats
