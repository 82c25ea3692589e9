"""The static sharding check.

Counterpart of ``check_sharding`` in ``paddle_tpu/analysis/shape_check.py``
(``:206-312``): every ``VarDesc.sharding`` annotation is checked against a
``MeshPlan`` before anything runs: the axis names exist in the plan, no
axis shards two dims of one var, the spec is no longer than the var's
rank, and each sharded dim divides by the product of its axes' sizes.
The flash ops' gspmd tags must divide their batch and head extents, and a
tagged forward's grad ops must be tagged too.  The static shape check of
the rest of that module is not ported yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from paddle_tpu_torch.analysis.verifier import Diagnostic, VerifierError

_ERROR = "error"
_WARNING = "warning"


class ShardingCheckError(VerifierError):
    """A VarDesc.sharding annotation is illegal for the MeshPlan."""

    code = "sharding_check"


def _axes_of(entry):
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def check_sharding(program, plan, raise_=True, label=""):
    """Every annotation and gspmd attention tag of ``program`` against
    ``plan`` (``parallel.gspmd.MeshPlan``).  Returns the diagnostics;
    raises ``ShardingCheckError`` on an error."""
    diags = []
    for block in program.blocks:
        for name, v in block.vars.items():
            spec = v.sharding
            if spec is None:
                continue
            if v.shape is None:
                diags.append(Diagnostic(
                    "sharding-unknown-shape",
                    "sharded var has no declared shape",
                    severity=_WARNING, block_idx=block.idx, var=name))
                continue
            if len(spec) > len(v.shape):
                diags.append(Diagnostic(
                    "sharding-rank",
                    f"spec {spec!r} is longer than the var rank "
                    f"{len(v.shape)}",
                    block_idx=block.idx, var=name))
                continue
            used = []
            for dim, entry in enumerate(spec):
                factor = 1
                for a in _axes_of(entry):
                    if a not in plan.axes:
                        diags.append(Diagnostic(
                            "sharding-unknown-axis",
                            f"dim {dim}: axis {a!r} is not in the "
                            f"plan {plan!r}",
                            block_idx=block.idx, var=name))
                        continue
                    if a in used:
                        diags.append(Diagnostic(
                            "sharding-axis-reuse",
                            f"dim {dim}: axis {a!r} already shards "
                            "another dim of this var (an axis shards one "
                            "dim of a var)",
                            block_idx=block.idx, var=name))
                    used.append(a)
                    factor *= plan.axis_size(a)
                extent = v.shape[dim]
                if extent is not None and extent >= 0 and factor > 1 \
                        and extent % factor != 0:
                    diags.append(Diagnostic(
                        "sharding-indivisible",
                        f"dim {dim}: extent {extent} is not divisible "
                        f"by {'x'.join(_axes_of(entry))} = {factor}",
                        block_idx=block.idx, var=name))

    gb = program.global_block()
    tagged = []
    for i, op in enumerate(gb.ops):
        if op.type not in ("flash_attention", "flash_attention_grad"):
            continue
        ba = op.attrs.get("gspmd_batch_axis") or None
        ha = op.attrs.get("gspmd_head_axis") or None
        if op.type == "flash_attention":
            tagged.append((i, op, ba or ha))
        if ba is None and ha is None:
            continue
        qname = (op.inputs.get("Q") or [None])[0]
        qvar = gb.vars.get(qname) if qname else None
        if qvar is None or qvar.shape is None or len(qvar.shape) != 4:
            continue
        B, H = qvar.shape[0], qvar.shape[1]
        for axis, extent, what in ((ba, B, "batch"), (ha, H, "head")):
            if axis is None:
                continue
            if axis not in plan.axes:
                diags.append(Diagnostic(
                    "sharding-unknown-axis",
                    f"gspmd_{what}_axis {axis!r} is not in the plan "
                    f"{plan!r}",
                    block_idx=0, op_idx=i, op_type=op.type))
            elif extent >= 0 and extent % plan.axis_size(axis) != 0:
                diags.append(Diagnostic(
                    "sharding-indivisible",
                    f"gspmd_{what}_axis {axis!r}: {what} extent "
                    f"{extent} is not divisible by "
                    f"{plan.axis_size(axis)}; the plan would gather q, k "
                    "and v and run the kernel on every head",
                    block_idx=0, op_idx=i, op_type=op.type))
    if any(t[2] for t in tagged):
        for i, op in enumerate(gb.ops):
            if op.type != "flash_attention_grad":
                continue
            if not (op.attrs.get("gspmd_batch_axis") or
                    op.attrs.get("gspmd_head_axis")):
                diags.append(Diagnostic(
                    "sharding-untagged-grad",
                    "flash_attention ops are gspmd-tagged but this grad op "
                    "is not: it recomputes the forward under its own "
                    "attrs, so its kernels would not run on the rank's "
                    "rows and heads",
                    block_idx=0, op_idx=i, op_type=op.type))

    if raise_ and any(d.severity == _ERROR for d in diags):
        raise ShardingCheckError(diags, label=label)
    return diags
