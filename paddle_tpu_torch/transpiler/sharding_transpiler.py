"""The sharding transpiler: a MeshPlan's annotations on the Program IR,
then the plan's mesh and rules on a CompiledProgram.

Counterpart of ``paddle_tpu/transpiler/sharding_transpiler.py``.  In the
JAX package ``apply`` makes the compiled step one ``jax.jit`` with in/out
shardings; here it makes ``CompiledProgram`` run its sharded plan
(``core/sharding.py``): each rank holds its block of every annotated var,
each feed is this rank's rows of the data axis, and the plan puts the
collectives at the layout boundaries.  The op graph is left alone.

Gated by the typed ``gspmd`` flag (default off): with it off,
``shard_program`` returns the CompiledProgram untouched and ``transpile``
changes no byte of the program.
"""

from __future__ import annotations

from paddle_tpu_torch.analysis.passes import checked_pass
from paddle_tpu_torch.parallel.gspmd import (MeshPlan, annotate_tp_transformer,
                                             annotate_zero3,
                                             partition_spec_of,
                                             tag_attention_ops)

__all__ = ["ShardingTranspiler", "shard_program"]


class ShardingTranspiler:
    """Two phases: ``transpile(program)`` writes the annotations (ZeRO-3,
    the transformer's tp splits, the attention tags), ``apply`` installs
    the mesh and the rules on a CompiledProgram.  A program annotated
    already (by hand, or carried through serialisation) can skip
    ``transpile``."""

    def __init__(self, plan: MeshPlan):
        if not isinstance(plan, MeshPlan):
            raise TypeError(f"plan must be a MeshPlan, got {plan!r}")
        self.plan = plan
        self.summary = {}

    @checked_pass("sharding_annotate")
    def transpile(self, program, zero3=True, tp=True, tag_attention=True,
                  min_size=2 ** 12):
        """Annotates ``program`` by the plan; returns a summary
        ({"zero3": [...], "tp": {...}, "attention_ops": N}).  With the
        gspmd flag off, nothing."""
        from paddle_tpu_torch.flags import get_flag

        if not get_flag("gspmd"):
            self.summary = {"enabled": False}
            return self.summary
        summary = {"enabled": True, "zero3": [], "tp": {},
                   "attention_ops": 0}
        if tp:
            summary["tp"] = annotate_tp_transformer(program, self.plan)
        if zero3:
            # after tp, so ZeRO takes the free dims of the tp layout
            summary["zero3"] = annotate_zero3(
                program, self.plan, min_size=min_size,
                axis=self.plan.data_axis)
        if tag_attention:
            summary["attention_ops"] = tag_attention_ops(program, self.plan)
        from paddle_tpu_torch.analysis.passes import verify_enabled

        if verify_enabled():
            from paddle_tpu_torch.analysis.shape_check import check_sharding

            check_sharding(program, self.plan, label="sharding_annotate")
        self.summary = summary
        return summary

    def sharding_rules(self, program):
        """The ``with_sharding_rules`` rule, (name, shape) -> PartitionSpec
        or None, read from the program's annotations."""
        plan = self.plan

        def rule(name, shape):
            for block in program.blocks:
                var = block.vars.get(name)
                if var is not None:
                    return partition_spec_of(var, plan, shape=shape)
            return None

        return rule

    def apply(self, compiled, loss_name=None, devices=None):
        """Installs the plan's mesh (over the world's ranks) and the
        annotations' rules on ``compiled``."""
        mesh = self.plan.build_mesh(devices=devices)
        compiled.with_data_parallel(loss_name=loss_name, mesh=mesh)
        compiled._data_axis = self.plan.data_axis
        compiled.with_sharding_rules(
            self.sharding_rules(compiled._program), mesh=mesh)
        return compiled


def shard_program(compiled, plan, loss_name=None, zero3=True, tp=True,
                  tag_attention=True, min_size=2 ** 12, devices=None,
                  annotate=True):
    """Annotates ``compiled``'s program by ``plan`` and installs the mesh
    and the rules.  With the gspmd flag off it returns ``compiled``
    untouched.  ``annotate=False`` applies a program annotated already."""
    from paddle_tpu_torch.flags import get_flag

    if not get_flag("gspmd"):
        return compiled
    t = ShardingTranspiler(plan)
    if annotate:
        t.transpile(compiled._program, zero3=zero3, tp=tp,
                    tag_attention=tag_attention, min_size=min_size)
    return t.apply(compiled, loss_name=loss_name, devices=devices)
