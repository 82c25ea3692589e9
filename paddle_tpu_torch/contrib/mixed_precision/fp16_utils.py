"""Inserts cast ops into a program by the AMP op lists.

Counterpart of ``paddle_tpu/contrib/mixed_precision/fp16_utils.py``
(``rewrite_program``), rule for rule, so both packages rewrite a program
into the same op list.  Master weights stay f32: a white op gets a cast
of each f32 input, per use.  The JAX package wraps the pass in its IR
verifier (``checked_pass("amp_rewrite")``); the verifier is not ported.
"""

from __future__ import annotations

from paddle_tpu_torch.contrib.mixed_precision.fp16_lists import \
    follow_x_list as _FOLLOW_X
from paddle_tpu_torch.core.program import OpDesc

_FLOATS = {"float32", "float64"}

# white ops whose numerically sensitive slots stay f32: conv2d_bn_train's
# BN statistics and parameters, as the unfused graph's gray batch_norm
# never casts them
_WHITE_KEEP_FP32 = {
    "conv2d_bn_train": frozenset({"Scale", "BNBias", "Mean", "Variance"}),
}

# white ops of several outputs of which only some are in the low dtype:
# conv2d_bn_train's statistics outputs stay f32
_WHITE_LOWP_OUT = {
    "conv2d_bn_train": frozenset({"Output"}),
}


def rewrite_program(program, amp_lists, dest_dtype="bfloat16"):
    """Rewrites the global block in place.  White ops get their float
    inputs cast to ``dest_dtype``; black (and unlisted) ops get their
    low-precision inputs cast back to f32; gray ops follow their inputs,
    low-precision only when every float input is.  Integer vars are never
    touched.  The set of vars that hold ``dest_dtype`` at run time is
    tracked along the op list."""
    block = program.global_block()

    def eligible(name):
        if not block.has_var(name):
            return True
        d = block.var(name).dtype
        return d is None or d in _FLOATS

    lowp = set()
    new_ops = []

    def insert_cast(name, dst, cache):
        key = (name, dst)
        if key in cache:
            return cache[key]
        cast_name = f"{name}.cast_{dst}"
        shape = block.var(name).shape if block.has_var(name) else None
        block.create_var(name=cast_name, dtype=dst, shape=shape)
        new_ops.append(OpDesc("cast", {"X": [name]}, {"Out": [cast_name]},
                              {"out_dtype": dst}))
        cache[key] = cast_name
        return cast_name

    for op in block.ops:
        cache = {}
        if op.type in amp_lists.white_list:
            keep = _WHITE_KEEP_FP32.get(op.type, frozenset())
            for slot, names in list(op.inputs.items()):
                if slot in keep:
                    continue
                out = []
                for n in names:
                    if eligible(n) and n not in lowp:
                        n = insert_cast(n, dest_dtype, cache)
                        lowp.add(n)
                    out.append(n)
                op.inputs[slot] = out
            out_lowp = True
        elif op.type in amp_lists.gray_list or op.type in _FOLLOW_X:
            if op.type in _FOLLOW_X:
                out_lowp = any(n in lowp for n in op.inputs.get("X", []))
            else:
                # type promotion makes the result low-precision only when
                # every float operand is
                float_ins = [n for ns in op.inputs.values() for n in ns
                             if eligible(n)]
                out_lowp = bool(float_ins) and all(
                    n in lowp for n in float_ins)
        else:
            for slot, names in list(op.inputs.items()):
                out = []
                for n in names:
                    if n in lowp:
                        n = insert_cast(n, "float32", cache)
                    out.append(n)
                op.inputs[slot] = out
            out_lowp = False
        if op.type == "cast":
            out_lowp = str(op.attrs.get("out_dtype")) == str(dest_dtype)
        new_ops.append(op)
        for slot, names in op.outputs.items():
            slot_lowp = out_lowp and (
                op.type not in _FOLLOW_X or slot == "Y")
            if op.type in _WHITE_LOWP_OUT:
                slot_lowp = out_lowp and slot in _WHITE_LOWP_OUT[op.type]
            for n in names:
                if slot_lowp and eligible(n):
                    lowp.add(n)
                else:
                    lowp.discard(n)
    block.ops = new_ops
    return program
