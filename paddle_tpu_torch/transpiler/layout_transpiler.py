"""The NHWC layout pass.

Counterpart of ``paddle_tpu/transpiler/layout_transpiler.py``
(``nhwc_transpile``, ``:1-225``), rule for rule, so both packages rewrite
a program into the same op list.  A user-built NCHW program runs NHWC
inside while its feeds, parameter shapes and non-4-D fetches keep their
meaning:

- conv2d / depthwise_conv2d / conv2d_transpose / pool2d and the fused
  conv2d_epilogue / conv2d_bn_train get ``data_format="NHWC"``,
  batch_norm ``data_layout="NHWC"``; filters stay OIHW.
- layout-agnostic elementwise ops are carried through in NHWC, and a
  channel-bias add's ``axis`` becomes -1.
- a ``transpose`` op is inserted where an NCHW var enters the NHWC region
  and where an NHWC var reaches a layout-sensitive consumer: for a
  ResNet, the image in and the pooled features out.

On the card NHWC is channels-last memory, the layout cuDNN and the
port's conv kernels read densely.  Run the pass on the forward program,
before ``minimize``.

``space_to_depth_stem`` (``:232-336`` there) rewrites a 7x7/s2/p3 image
stem as pad2d + space_to_depth of the image, pad + space_to_depth of the
filter and a 4x4/s1 valid conv on 4C channels, op for op as the JAX pass
does.  Run it before ``nhwc_transpile``: the s2d chain stays NCHW and the
NHWC pass puts one transpose at the conv's input.  Neither package's
passes are wrapped in an IR verifier here: the port has none yet.
"""

from __future__ import annotations

from paddle_tpu_torch.core.program import BACKWARD, OPTIMIZE, OpDesc

# ops whose compute honours a layout attr
_CONV_LIKE = {"conv2d", "depthwise_conv2d", "conv2d_transpose", "pool2d"}
_NORM_LIKE = {"batch_norm", "sync_batch_norm"}
_FUSED_CONV = {"conv2d_epilogue", "conv2d_bn_train"}

# unary elementwise ops that are layout-transparent: Out has X's layout
_UNARY_FLEX = {
    "relu", "relu6", "leaky_relu", "sigmoid", "logsigmoid", "tanh", "exp",
    "log", "sqrt", "rsqrt", "abs", "square", "reciprocal", "softplus",
    "softsign", "gelu", "elu", "selu", "swish", "hard_sigmoid",
    "hard_swish", "floor", "ceil", "round", "sin", "cos", "erf",
    "tanh_shrink", "softshrink", "hard_shrink", "thresholded_relu",
    "scale", "cast", "dropout", "clip", "assign", "pow", "label_smooth",
}

# binary elementwise ops that are layout-transparent when both sides share
# a layout, or when Y is a per-channel vector (axis retargeted)
_BINARY_FLEX = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
}

_NCHW_TO_NHWC = (0, 2, 3, 1)
_NHWC_TO_NCHW = (0, 3, 1, 2)


def _permute_shape(shape, perm):
    if shape is None or len(shape) != 4:
        return shape
    return tuple(shape[i] for i in perm)


class _Rewriter:
    def __init__(self, block):
        self.block = block
        self.new_ops = []
        self.nhwc = set()          # var names currently NHWC
        self.to_nchw = {}          # nhwc var -> name of its NCHW copy
        self.to_nhwc = {}          # nchw var -> name of its NHWC copy

    def _emit_transpose(self, name, perm, suffix, cache, mark_nhwc):
        if name in cache:
            return cache[name]
        src = self.block.var(name)
        out_name = name + suffix
        out = self.block.create_var(
            out_name, shape=_permute_shape(src.shape, perm),
            dtype=src.dtype)
        out.stop_gradient = src.stop_gradient
        self.new_ops.append(OpDesc(
            "transpose", {"X": [name]}, {"Out": [out_name]},
            {"axis": list(perm)}))
        cache[name] = out_name
        if mark_nhwc:
            self.nhwc.add(out_name)
        return out_name

    def as_nhwc(self, name):
        """The name of ``name`` in NHWC (transposing when needed)."""
        if name in self.nhwc:
            return name
        return self._emit_transpose(name, _NCHW_TO_NHWC, "@NHWC",
                                    self.to_nhwc, mark_nhwc=True)

    def as_nchw(self, name):
        if name not in self.nhwc:
            return name
        return self._emit_transpose(name, _NHWC_TO_NCHW, "@NCHW",
                                    self.to_nchw, mark_nhwc=False)

    def mark_out_nhwc(self, op, slot):
        for n in op.outputs.get(slot, []):
            self.nhwc.add(n)
            v = self.block.var(n)
            v.shape = _permute_shape(v.shape, _NCHW_TO_NHWC)

    def _is_4d(self, name):
        v = self.block.var(name)
        return v.shape is not None and len(v.shape) == 4

    def rewrite(self, op):
        t = op.type
        if t in _FUSED_CONV:
            # Input and the optional Residual ride in NHWC; the 1-D
            # Bias/Scale/BNBias/Mean/Variance have no layout
            op.inputs["Input"][0] = self.as_nhwc(op.inputs["Input"][0])
            if "Residual" in op.inputs:
                op.inputs["Residual"][0] = self.as_nhwc(
                    op.inputs["Residual"][0])
            op.set_attr("data_format", "NHWC")
            self.new_ops.append(op)
            self.mark_out_nhwc(op, "Output")
            return
        if t in _CONV_LIKE:
            slot = "Input" if "Input" in op.inputs else "X"
            op.inputs[slot][0] = self.as_nhwc(op.inputs[slot][0])
            op.set_attr("data_format", "NHWC")
            self.new_ops.append(op)
            self.mark_out_nhwc(op, "Output" if "Output" in op.outputs
                               else "Out")
            return
        if t in _NORM_LIKE:
            src = op.inputs["X"][0]
            if src in self.nhwc or self._is_4d(src):
                op.inputs["X"][0] = self.as_nhwc(src)
                op.set_attr("data_layout", "NHWC")
                self.new_ops.append(op)
                self.mark_out_nhwc(op, "Y")
                return
            self.new_ops.append(op)
            return
        if t in _UNARY_FLEX:
            if op.inputs["X"][0] in self.nhwc:
                for n in op.output_names():
                    if self._is_4d(n) or self.block.var(n).shape is None:
                        self.nhwc.add(n)
                        v = self.block.var(n)
                        v.shape = _permute_shape(v.shape, _NCHW_TO_NHWC)
            self.new_ops.append(op)
            return
        if t in _BINARY_FLEX:
            self._rewrite_binary(op)
            return
        # a layout-sensitive consumer: feed it NCHW
        for slot, names in op.inputs.items():
            op.inputs[slot] = [self.as_nchw(n) for n in names]
        self.new_ops.append(op)

    def _rewrite_binary(self, op):
        x, y = op.inputs["X"][0], op.inputs["Y"][0]
        x_h, y_h = x in self.nhwc, y in self.nhwc
        xv, yv = self.block.var(x), self.block.var(y)
        if x_h and (y_h or yv.ndim == 4):
            op.inputs["Y"][0] = self.as_nhwc(y)
        elif x_h and yv.ndim == 1 and op.attrs.get("axis", -1) == 1:
            # per-channel bias: C is now the trailing axis
            op.set_attr("axis", -1)
        elif x_h and yv.ndim in (0, 1) and (
                yv.ndim == 0 or (yv.shape and yv.shape[0] == 1)):
            pass                  # a scalar broadcasts in any layout
        elif y_h and not x_h and xv.ndim == 4:
            op.inputs["X"][0] = self.as_nhwc(x)
        else:
            # mixed or unsupported: NCHW operands
            op.inputs["X"][0] = self.as_nchw(x)
            op.inputs["Y"][0] = self.as_nchw(y)
            self.new_ops.append(op)
            return
        self.new_ops.append(op)
        self.mark_out_nhwc(op, "Out")


def _assert_forward_only(program, pass_name):
    for b in program.blocks:
        for op in b.ops:
            if op.op_role in (BACKWARD, OPTIMIZE):
                raise ValueError(
                    f"{pass_name} must run before append_backward/"
                    f"minimize; found a {op.op_role} op '{op.type}'")


def nhwc_transpile(program):
    """Rewrites ``program`` in place so its conv/pool/norm chains run
    NHWC; returns it.  Raises on a program that already holds backward or
    optimizer ops."""
    _assert_forward_only(program, "nhwc_transpile")
    for block in program.blocks:
        if not any(op.type in _CONV_LIKE or op.type in _FUSED_CONV
                   for op in block.ops):
            continue
        rw = _Rewriter(block)
        for op in block.ops:
            rw.rewrite(op)
        block.ops = rw.new_ops
    return program


# ---------------------------------------------------------------------------
# the space-to-depth image stem
# ---------------------------------------------------------------------------

def _stem_candidates(block):
    """The conv2d ops of a classic image stem: 7x7, stride 2, pad 3,
    undilated, one group, NCHW, at most 4 input channels, on an input of
    static even height and width."""
    out = []
    for op in block.ops:
        if op.type != "conv2d":
            continue
        a = op.attrs
        if (list(a.get("strides", [1, 1])) != [2, 2]
                or list(a.get("paddings", [0, 0])) != [3, 3]
                or list(a.get("dilations", [1, 1])) != [1, 1]
                or a.get("groups", 1) != 1
                or a.get("data_format", "NCHW") != "NCHW"):
            continue
        w = block.var(op.inputs["Filter"][0])
        x = block.var(op.inputs["Input"][0])
        if w.shape is None or x.shape is None or len(x.shape) != 4:
            continue
        _, c, kh, kw = w.shape
        if (kh, kw) != (7, 7) or c > 4:
            continue
        h, wd = x.shape[2], x.shape[3]
        if not (isinstance(h, int) and isinstance(wd, int) and h > 0
                and wd > 0 and h % 2 == 0 and wd % 2 == 0):
            continue
        out.append(op)
    return out


def space_to_depth_stem(program):
    """Rewrites each 7x7/s2/p3 image stem of ``program`` (in place) as
    space-to-depth and a 4x4/s1 valid conv; returns the program.

    out[y, x] = sum over c, p, q of w[o, c, p, q] in[c, 2y+p-3, 2x+q-3].
    The image is padded by 4 above and left, 2 below and right, then
    space_to_depth 2 makes [4C, (H+6)/2, (W+6)/2]; the filter is padded
    by 1 on the left of each spatial dim ([O, C, 8, 8], the new tap has
    weight 0), then space_to_depth 2 makes [O, 4C, 4, 4].  Both are plain
    ops, so the grads reach the original [O, C, 7, 7] weight.  Raises on
    a program that already holds backward or optimizer ops."""
    _assert_forward_only(program, "space_to_depth_stem")
    for block in program.blocks:
        for conv in _stem_candidates(block):
            xname = conv.inputs["Input"][0]
            wname = conv.inputs["Filter"][0]
            xv, wv = block.var(xname), block.var(wname)
            n, c, h, w = xv.shape
            o = wv.shape[0]
            pre = []

            def mk(name, shape, like):
                v = block.create_var(name, shape=shape, dtype=like.dtype)
                v.stop_gradient = like.stop_gradient
                return v

            xpad = mk(xname + "@S2DPAD", (n, c, h + 6, w + 6), xv)
            pre.append(OpDesc("pad2d", {"X": [xname]},
                              {"Out": [xpad.name]},
                              {"paddings": [4, 2, 4, 2],
                               "mode": "constant", "pad_value": 0.0,
                               "data_format": "NCHW"}))
            xs = mk(xname + "@S2D", (n, 4 * c, (h + 6) // 2,
                                     (w + 6) // 2), xv)
            pre.append(OpDesc("space_to_depth", {"X": [xpad.name]},
                              {"Out": [xs.name]}, {"blocksize": 2}))
            wpad = mk(wname + "@S2DPAD", (o, c, 8, 8), wv)
            pre.append(OpDesc("pad", {"X": [wname]},
                              {"Out": [wpad.name]},
                              {"paddings": [0, 0, 0, 0, 1, 0, 1, 0],
                               "pad_value": 0.0}))
            ws = mk(wname + "@S2D", (o, 4 * c, 4, 4), wv)
            pre.append(OpDesc("space_to_depth", {"X": [wpad.name]},
                              {"Out": [ws.name]}, {"blocksize": 2}))
            conv.inputs["Input"] = [xs.name]
            conv.inputs["Filter"] = [ws.name]
            conv.set_attr("strides", [1, 1])
            conv.set_attr("paddings", [0, 0])
            idx = block.ops.index(conv)
            block.ops[idx:idx] = pre
    return program
