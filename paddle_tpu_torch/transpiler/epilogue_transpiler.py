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
package's wrappers do.  The JAX package's IR verifier around the pass
(``checked_pass``) and the int8 interlayer fold are not ported.

Run it before ``nhwc_transpile`` and before ``minimize``, so the backward
derives from the fused ops.
"""

from __future__ import annotations

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
