"""The post-training int8 passes.

Counterpart of ``paddle_tpu/contrib/slim/quantization.py``, pass for pass,
so both packages rewrite a program into the same op list:

- ``quantize_weights_abs_max`` (``:472``): channel-wise abs-max int8
  weights of the conv and mul parameters;
- ``post_training_quantize`` (``:193``): per-tensor abs-max scales of the
  activations, read from the scope after each calibration batch (the
  executor keeps every op's output there), with ``fold_boundaries`` and
  the 1e-8 floor for an activation observed all zero (warned once);
- ``convert_to_int8_inference`` (``:268``): dequantise-on-load weights;
- ``convert_to_int8_execution`` (``:325``): conv2d / mul on int8 weights
  become ``conv2d_int8`` / ``mul_int8`` with a calibrated ``InScale``;
  with ``int8_activations`` (flag ``int8_interlayer``),
  ``_fold_int8_interlayer`` (``:454``) folds the int8 edges and leaves
  its statistics on ``program._int8_interlayer_stats``.

The JAX passes carry the IR verifier's ``checked_pass``; the port has no
verifier yet (ROADMAP Queue 1 item 6) and applies none, as its other
passes do.  The QAT passes are not ported yet (same item).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from paddle_tpu_torch.core.program import OpDesc
from paddle_tpu_torch.core.types import from_numpy, to_numpy

_QUANTIZABLE = ("conv2d", "depthwise_conv2d", "mul", "matmul")
# op input slots holding weights (vs activations)
_WEIGHT_SLOTS = {
    "conv2d": ("Filter",),
    "depthwise_conv2d": ("Filter",),
    "mul": ("Y",),
    "matmul": ("Y",),
}
# ops whose outputs are int8 interlayer fold-boundary candidates: the
# tensor a fused requantize emits can sit behind a bias add and a relu
_FOLD_BOUNDARY_OPS = ("relu", "elementwise_add")
_INT8_EXEC_WSLOT = {"conv2d": "Filter", "depthwise_conv2d": "Filter",
                    "mul": "Y"}

_warned_zero_scale = [False]


def post_training_quantize(program, scope, executor, feed_batches,
                           fetch_list=None, weight_bits=8,
                           activation_bits=8, fold_boundaries=False):
    """Runs the calibration batches and returns ``({var: abs-max scale},
    {weight: (int8 ndarray, scale)})``: a per-tensor scale for every
    activation a quantizable op reads (and, with ``fold_boundaries``,
    every quantizable op's, relu's and elementwise_add's output, which
    the interlayer fold needs) and per-tensor abs-max int8 weights.  An
    activation observed all zero gets 1e-8, not 0.0 (which means never
    observed, and sends the converted op down the dynamic path), with
    one warning a process."""
    block = program.global_block()
    act_names = set()
    params = {v.name for v in program.all_parameters()}
    weight_names = set()
    for op in block.ops:
        if op.type in _QUANTIZABLE:
            wslots = _WEIGHT_SLOTS.get(op.type, ())
            for slot, names in op.inputs.items():
                for n in names:
                    if slot in wslots and n in params:
                        weight_names.add(n)
                    else:
                        act_names.add(n)
        if fold_boundaries and op.type in (
                _QUANTIZABLE + _FOLD_BOUNDARY_OPS):
            for names in op.outputs.values():
                act_names.update(names)
    act_names -= params
    scales = {n: 0.0 for n in act_names}
    observed = set()
    for feed in feed_batches:
        executor.run(program, feed=feed, fetch_list=fetch_list or [],
                     scope=scope)
        for n in act_names:
            var = scope.find_var(n)
            if var is not None and var.get() is not None:
                observed.add(n)
                scales[n] = max(scales[n], float(
                    torch.amax(torch.abs(var.get()))))
    zeros = [n for n in observed if scales[n] <= 0.0]
    if zeros:
        if not _warned_zero_scale[0]:
            warnings.warn(
                "post_training_quantize: %d activation(s) were observed "
                "all-zero during calibration (e.g. %s); flooring their "
                "recorded scales at 1e-8 so they stay on the calibrated "
                "static-scale path instead of silently falling back to "
                "the dynamic max-reduction" % (len(zeros), zeros[0]),
                stacklevel=2)
            _warned_zero_scale[0] = True
        for n in zeros:
            scales[n] = 1e-8
    bnd = float(2 ** (weight_bits - 1) - 1)
    weights = {}
    for n in weight_names:
        w = to_numpy(scope.find_var(n).get(), n)
        s = max(float(np.max(np.abs(w))), 1e-8)
        weights[n] = (np.clip(np.round(w / s * bnd), -bnd, bnd)
                      .astype(np.int8), np.float32(s))
    return scales, weights


def _device_of(scope, names):
    """The device of the first of ``names`` that the scope holds (the
    converted state goes where the program's parameters are)."""
    for n in names:
        var = scope.find_var(n)
        if var is not None and isinstance(var.get(), torch.Tensor):
            return var.get().device
    return torch.device("cpu")


def _store_int8_weight(block, scope, name, q, scale):
    """``<name>@INT8`` and ``<name>@SCALE`` as persistables in the block
    and the scope (on the fp32 weight's device), the fp32 var made
    non-persistable and its value dropped.  Shared by the two
    converters."""
    qname, sname = name + "@INT8", name + "@SCALE"
    if qname in block.vars:
        return qname, sname
    block.create_var(name=qname, shape=q.shape, dtype="int8",
                     persistable=True)
    block.create_var(name=sname, shape=np.shape(scale),
                     dtype="float32", persistable=True)
    device = _device_of(scope, [name])
    scope.var(qname).set(from_numpy(np.asarray(q), qname).to(device))
    scope.var(sname).set(from_numpy(np.asarray(scale, np.float32),
                                    sname).to(device))
    v = block.vars.get(name)
    if v is not None:
        v.persistable = False
    svar = scope.find_var(name)
    if svar is not None:
        svar.set(None)
    return qname, sname


def convert_to_int8_inference(program, scope, quant_weights,
                              weight_bits=8):
    """Each quantised parameter becomes a non-persistable var produced at
    the program's start by a ``dequantize_weight`` op from its int8
    tensor and scale (``quant_weights``: {param: (int8, scale)})."""
    block = program.global_block()
    bnd = float(2 ** (weight_bits - 1) - 1)
    dequant_ops = []
    for name, (q, scale) in quant_weights.items():
        if name not in block.vars:
            continue
        qname, sname = _store_int8_weight(block, scope, name, q, scale)
        dequant_ops.append(OpDesc(
            "dequantize_weight", {"X": [qname], "Scale": [sname]},
            {"Out": [name]}, {"max_range": bnd}))
    block.ops = dequant_ops + block.ops
    return program


def convert_to_int8_execution(program, scope, quant_weights,
                              weight_bits=8, act_scales=None,
                              out_dtype="float32",
                              int8_activations=None, protected=None):
    """Each conv2d / depthwise_conv2d (with groups) / mul whose weight is
    in ``quant_weights`` and read by no other op becomes a
    ``conv2d_int8`` / ``mul_int8`` on the int8 weight and its scale, with
    a calibrated ``InScale`` where ``act_scales`` has a positive scale for
    its activation (the dynamic max|x| otherwise); other quantised
    weights are dequantised on load.  ``int8_activations`` (None reads
    flag ``int8_interlayer``) then folds the int8 edges
    (``_fold_int8_interlayer``), keeping ``protected`` names float."""
    block = program.global_block()
    bnd = float(2 ** (weight_bits - 1) - 1)
    act_scales = act_scales or {}
    device = _device_of(scope, quant_weights)

    def _scale_input(in_name):
        s = float(act_scales.get(in_name, 0.0))
        if s <= 0.0:
            return {}
        sname = in_name + "@ACT_SCALE"
        if sname not in block.vars:
            block.create_var(name=sname, shape=(1,), dtype="float32",
                             persistable=True)
            scope.var(sname).set(torch.full((1,), s, dtype=torch.float32,
                                            device=device))
        return {"InScale": [sname]}

    # a weight is stripped only when every consumer, in every block,
    # converts to an int8 op of the global block
    convertible = set()
    blocked = set()
    for blk in program.blocks:
        for op in blk.ops:
            wslot = _INT8_EXEC_WSLOT.get(op.type)
            consumed = {n for names in op.inputs.values() for n in names}
            conv_w = set()
            if blk is block and wslot and not (
                    op.type == "depthwise_conv2d"
                    and not op.attrs.get("groups")):
                conv_w = (set(op.inputs.get(wslot, []))
                          & set(quant_weights))
                convertible |= conv_w
            blocked |= (consumed & set(quant_weights)) - conv_w
    convertible -= blocked

    converted = set()
    new_ops = []
    for op in block.ops:
        wslot = _INT8_EXEC_WSLOT.get(op.type)
        wnames = op.inputs.get(wslot, []) if wslot else []
        wname = wnames[0] if wnames else None
        if wname in convertible:
            q, scale = quant_weights[wname]
            qname, sname = _store_int8_weight(block, scope, wname, q,
                                              scale)
            converted.add(wname)
            if op.type == "mul":
                new_ops.append(OpDesc(
                    "mul_int8",
                    {"X": list(op.inputs["X"]), "Y": [qname],
                     "Scale": [sname],
                     **_scale_input(op.inputs["X"][0])},
                    {"Out": list(op.outputs["Out"])},
                    {"x_num_col_dims": op.attrs.get("x_num_col_dims", 1),
                     "y_num_col_dims": op.attrs.get("y_num_col_dims", 1),
                     "max_range": bnd, "out_dtype": out_dtype}))
            else:
                new_ops.append(OpDesc(
                    "conv2d_int8",
                    {"Input": list(op.inputs["Input"]),
                     "Filter": [qname], "FilterScale": [sname],
                     **_scale_input(op.inputs["Input"][0])},
                    {"Output": list(op.outputs["Output"])},
                    {"strides": op.attrs.get("strides", [1, 1]),
                     "paddings": op.attrs.get("paddings", [0, 0]),
                     "dilations": op.attrs.get("dilations", [1, 1]),
                     "groups": op.attrs.get("groups", 1),
                     "data_format": op.attrs.get("data_format", "NCHW"),
                     "max_range": bnd, "out_dtype": out_dtype}))
        else:
            new_ops.append(op)
    block.ops = new_ops
    leftovers = {k: v for k, v in quant_weights.items()
                 if k not in converted and k in block.vars}
    if leftovers:
        convert_to_int8_inference(program, scope, leftovers, weight_bits)
    if int8_activations is None:
        from paddle_tpu_torch.flags import get_flag

        int8_activations = get_flag("int8_interlayer")
    if int8_activations:
        program._int8_interlayer_stats = _fold_int8_interlayer(
            program, block, out_dtype, weight_bits,
            frozenset(protected or ()))
    return program


def _fold_int8_interlayer(program, block, out_dtype, weight_bits,
                          protected):
    """The int8 interlayer fold; the walk lives in the epilogue pass
    (``transpiler/epilogue_transpiler.py::fold_int8_interlayer``), as in
    the JAX package."""
    from paddle_tpu_torch.transpiler.epilogue_transpiler import \
        fold_int8_interlayer

    return fold_int8_interlayer(program, block, out_dtype, weight_bits,
                                protected)


def quantize_weights_abs_max(program, scope, weight_bits=8,
                             ops=("conv2d", "depthwise_conv2d", "mul")):
    """Channel-wise (axis 0) abs-max int8 weights of the persistable
    parameters the conv and mul ops read: {param: (int8 ndarray, f32
    scale [O, 1, ...])}, computed in numpy from the scope's values."""
    block = program.global_block()
    bnd = float(2 ** (weight_bits - 1) - 1)
    out = {}
    wslots = {"conv2d": ("Filter",), "depthwise_conv2d": ("Filter",),
              "mul": ("Y",), "conv3d": ("Filter",)}
    for op in block.ops:
        for slot in wslots.get(op.type, ()):
            for name in op.inputs.get(slot, ()):
                if name in out or name not in block.vars or \
                        not block.vars[name].persistable:
                    continue
                var = scope.find_var(name)
                if var is None or var.get() is None:
                    continue
                w = to_numpy(var.get(), name)
                red = tuple(range(1, w.ndim))
                scale = np.maximum(
                    np.max(np.abs(w), axis=red, keepdims=True), 1e-8)
                q = np.clip(np.round(w / scale * bnd), -bnd,
                            bnd).astype(np.int8)
                out[name] = (q, scale.astype(np.float32))
    return out
