"""The epilogue-fusion pass, fc anchor.

Counterpart of ``paddle_tpu/transpiler/epilogue_transpiler.py``: the same
walk and guards, so both packages rewrite a program into the same op
list.  Anchor ``fc``: ``mul`` (+ channel bias add) (+ same-shape residual
add) (+ relu or gelu) becomes one ``fc_epilogue`` op carrying the matched
stages in its ``epilogue`` attr (``ops/epilogue.py``).  Every fused
intermediate is sole-consumed and unprotected.

The ``conv`` and ``conv_bn`` anchors emit ops whose kernels the ResNet
slice ports; asking for them raises ``NotImplementedError``, the default
``anchors`` included, rather than fusing part of what was asked.  The
JAX package's IR verifier around the pass (``checked_pass``) and the
int8 interlayer fold are not ported.

Run it before ``minimize``, so the backward derives from the fused ops.
"""

from __future__ import annotations

from paddle_tpu_torch.core.program import OpDesc
from paddle_tpu_torch.ops.epilogue import spec_attr
from paddle_tpu_torch.transpiler.inference_transpiler import (
    _consumers, _first_consumer)

_FC_ACTS = ("relu", "gelu")


class EpilogueFusionTranspiler:
    ANCHORS = ("conv", "conv_bn", "fc")

    def transpile(self, program, protected=None, anchors=ANCHORS):
        """Fuses every chain of the given anchors in place; returns the
        number of chains fused."""
        for anchor in anchors:
            if anchor in ("conv", "conv_bn"):
                raise NotImplementedError(
                    f"fuse_epilogue: anchor {anchor!r} emits conv ops "
                    "that the ResNet slice of the port brings; pass "
                    "anchors=('fc',)")
            if anchor != "fc":
                raise ValueError(f"unknown epilogue anchor {anchor!r}")
        self._protected = frozenset(protected or ())
        block = program.global_block()
        n = 0
        while anchors and self._fuse_one_fc(block):
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
            if nxt is not None and nxt.type in _FC_ACTS:
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
