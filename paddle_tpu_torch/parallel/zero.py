"""ZeRO-style sharding of optimizer state.

Counterpart of ``paddle_tpu/parallel/zero.py``: the same rule builder
(``zero_sharding_rules``), the same exact optimizer-state detection
(``collect_optimizer_state``) and name-marker fallback.  The JAX package
hands the rule to ``CompiledProgram.with_sharding_rules`` and XLA's SPMD
partitioner emits the reduce-scatter/all-gather pattern.  Here the
compiled program's layout engine does it by hand (``core/sharding.py``):
each rank holds and updates dim-0 rows of every sharded accumulator and
of its parameter, the gradients are reduce-scattered into those rows,
and the updated parameter rows are all-gathered (stages 1 and 2, one
rule as in the JAX package: stage 2's gradient sharding is the
reduce-scatter).  Stage 3 shards the parameters themselves, which stay
sharded between steps and are gathered where they are used: the same
layouts ``transpiler.shard_program``'s ZeRO-3 annotations give, so the
two train alike.

``PartitionSpec`` is the port's own (``jax.sharding.PartitionSpec``'s
shape: one mesh axis or None a dim).
"""

from __future__ import annotations

from typing import Optional

# fallback accumulator name fragments generated by
# Optimizer._add_accumulator (optimizer.py: f"{param.name}_{name}" +
# unique suffix) — used only when no program is given for exact
# detection
_ACC_MARKERS = (
    "_moment", "_velocity", "_beta1_pow", "_beta2_pow", "_inf_norm",
    "_mean_square", "_mean_grad", "_avg_squared", "_squared_", "_linear_",
    "_momentum",
)


class PartitionSpec(tuple):
    """A mesh axis name (or None) for each dim of a tensor."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec


def is_optimizer_accumulator(name: str) -> bool:
    return any(m in name for m in _ACC_MARKERS)


def collect_optimizer_state(program):
    """EXACT optimizer-state var names of a built program: persistable
    non-parameter vars that an optimize-role op both reads and writes
    (the in-place accumulator update signature).  No name patterns —
    a renamed accumulator cannot silently escape sharding."""
    gb = program.global_block()
    params = {v.name for v in program.all_parameters()}
    state = set()
    for op in gb.ops:
        if op.op_role != "optimize":
            continue
        ins = {n for ns in op.inputs.values() for n in ns}
        outs = {n for ns in op.outputs.values() for n in ns}
        for n in (ins & outs) - params:
            v = gb.vars.get(n)
            if v is not None and v.persistable:
                state.add(n)
    return state


def zero_sharding_rules(stage: int = 1, axis: str = "dp",
                        min_size: int = 2 ** 12,
                        extra_rule=None, program=None):
    """Build a var-name -> PartitionSpec rule for
    CompiledProgram.with_sharding_rules.

    Shards dim 0 over ``axis`` for optimizer-state vars (stage >= 1)
    and for parameters too (stage >= 3).  Small tensors (< min_size
    elements, e.g. biases, beta-pow scalars) stay replicated — sharding
    them costs more in collective latency than it saves.  ``extra_rule``
    (name, shape) -> spec runs first so TP layouts compose with ZeRO.

    Pass ``program`` for exact optimizer-state detection (derived from
    the optimize ops' in-place update signature); without it a
    name-marker heuristic is used."""
    exact_cache = []

    def exact_state():
        # lazy + guarded: a rule built before minimize() appends the
        # optimize ops must not snapshot an empty set
        if not exact_cache:
            s = collect_optimizer_state(program)
            if not s:
                return None  # not cached: ops may appear later
            exact_cache.append(s)
        return exact_cache[0]

    def rule(name: str, shape: tuple) -> Optional[PartitionSpec]:
        if extra_rule is not None:
            ps = extra_rule(name, shape)
            if ps is not None:
                return ps
        size = 1
        for d in shape:
            size *= int(d)
        if not shape or size < min_size:
            return None
        exact = exact_state() if program is not None else None
        is_state = (name in exact) if exact is not None \
            else is_optimizer_accumulator(name)
        if not (is_state or stage >= 3):
            return None
        return P(axis, *([None] * (len(shape) - 1)))

    return rule
