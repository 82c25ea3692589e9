"""Data parallelism of ``CompiledProgram``: the gradient collectives as
steps of the plan, and the step's fetch rules.

The JAX package gets data parallelism from GSPMD: every feed's batch dim
is sharded over the mesh and XLA partitions the whole step, so the loss
and the gradients are the global batch's, batch statistics too, and a
fetch sharded over processes is gathered
(``paddle_tpu/core/compiler.py:583-628``, ``:740-929``).  Here one
process drives one device and the plan does by hand what the
partitioner does:

- Between the backward ops and the first optimize op, the gradients the
  optimize ops read are summed over the data axis and divided by its
  ranks (each rank's loss is its local batch's mean, so the result is
  the global batch's mean gradient), in one flat bucket a dtype (the
  reference's ``fuse_all_reduce_ops``; the JAX package, like the port,
  has no unfused form).
- Any sharding rule (``with_sharding_rules``: ZeRO's stages, tensor
  layouts, any partition spec over the mesh's axes) runs through the
  layout engine, ``core/sharding.py``, which reduces the gradients the
  same way and keeps this rank's blocks of the sharded persistables out
  of the scope: its entry of one is a ``ShardedVariable``, which refuses
  a read.  AMP's ``check_finite_and_unscale`` over blocks of the
  gradients gets a flag made global (``found_inf_step``).
- The program is never changed: these are steps of the plan only.

Every step speaks ``ResolvedOp``'s contract (``input_names``,
``output_names``, ``gather``, ``compute``, ``scatter``), so the plan runs,
captures and replays them as it does an op.
"""

from __future__ import annotations

import types

import torch

from paddle_tpu_torch.core.program import BACKWARD, OPTIMIZE
from paddle_tpu_torch.core.scope import Variable
from paddle_tpu_torch.parallel import env as penv


class DataParallelFetchError(ValueError):
    """A fetch of a data-parallel step that the port cannot make global:
    neither the loss, nor batch-major, nor a persistable or a reduced
    gradient (equal on every rank)."""

    def __init__(self, name):
        self.name = name
        super().__init__(
            f"data-parallel fetch '{name}': only the loss (its global "
            "mean), a value whose leading dim is the batch (gathered in "
            "rank order), a persistable or a reduced gradient can be "
            f"fetched; this rank's '{name}' is not the global batch's")


class PlanStep:
    """A step of the plan that is no op of the program: ``fn(values) ->
    values`` from the ``ins`` names to the ``outs`` names."""

    __slots__ = ("op", "ins", "outs", "fn")

    def __init__(self, type, ins, outs, fn):
        self.op = types.SimpleNamespace(type=type, attrs={})
        self.ins, self.outs, self.fn = tuple(ins), tuple(outs), fn

    def input_names(self):
        return list(self.ins)

    def output_names(self):
        return list(self.outs)

    def gather(self, get):
        vals = [get(n) for n in self.ins]
        missing = [n for n, v in zip(self.ins, vals) if v is None]
        if missing:
            raise RuntimeError(f"{self.op.type}: inputs {missing} are unset")
        return vals

    def compute(self, ins, device):
        return self.fn(ins)

    def scatter(self, outs, put):
        for n, v in zip(self.outs, outs):
            put(n, v)


def _by_dtype(vals):
    groups = {}
    for i, v in enumerate(vals):
        groups.setdefault(v.dtype, []).append(i)
    return groups.values()


def all_reduce_step(grads, group, size):
    """The gradients' mean over the ranks: one flat bucket a dtype."""

    def fn(vals):
        out = [None] * len(vals)
        for idxs in _by_dtype(vals):
            flat = torch.cat([vals[i].reshape(-1) for i in idxs])
            flat = penv.collective("all_reduce", flat, group, size) / size
            for i, part in zip(idxs, flat.split(
                    [vals[i].numel() for i in idxs])):
                out[i] = part.view(vals[i].shape)
        return out

    return PlanStep("c_allreduce_sum", grads, grads, fn)


def found_inf_step(found, grads, zero_on_inf, group, size):
    """AMP's overflow flag ``found`` (written by ``check_finite_and_unscale``
    on this rank's blocks of the sharded gradients) made the max over the
    ranks, and with ``zero_on_inf`` the unscaled ``grads`` zeroed where it
    is set: each rank's check zeroed them only where its own blocks
    overflowed."""
    names = [found] + (list(grads) if zero_on_inf else [])

    def fn(vals):
        flag = penv.collective("all_reduce", vals[0].to(torch.int32), group,
                               size, reduce="max").to(vals[0].dtype)
        inf = flag.reshape(()).bool()
        return [flag] + [torch.where(inf, torch.zeros_like(g), g)
                         for g in vals[1:]]

    return PlanStep("c_allreduce_max", names, names, fn)


class ZeroShardedError(RuntimeError):
    """A read, outside the compiled program that shards it, of a sharded
    persistable: no rank holds its whole value."""


class ShardedVariable(Variable):
    """The scope's entry of a sharded persistable while a
    ``CompiledProgram`` holds this rank's block of it (``rows``, described
    by ``r``, a ``core.sharding.Shard``).  Reading it
    raises ``ZeroShardedError``: the blocks differ by rank and no rank
    holds the whole.  A whole value set in its place is read back as it
    is, and the program shards it anew at its next run."""

    def __init__(self, name, rows, r):
        super().__init__(name)
        self.rows, self.r = rows, r

    def holds(self, r):
        """Whether the entry still holds the block ``r``."""
        return self.value is None and self.r.key() == r.key()

    def get(self):
        if self.value is None:
            raise ZeroShardedError(
                f"'{self.name}' is sharded: this rank holds "
                f"{self.r.describe()} in the CompiledProgram that updates "
                "it, and no rank holds the whole value; fetch it through "
                "that program (the fetch gathers the blocks), or read this "
                "rank's block with CompiledProgram.sharded_state()")
        return self.value


def step_grads(ops):
    """(index of the first optimize op, the gradients the optimize ops
    read that backward ops wrote, in the order first read).  Raises where
    a backward op follows an optimize op: its gradient would miss the
    reduction."""
    first, written, grads = None, set(), []
    for i, op in enumerate(ops):
        if op.op_role == BACKWARD:
            if first is not None:
                raise NotImplementedError(
                    f"with_data_parallel: backward op '{op.type}' after "
                    f"the optimize op '{ops[first].type}'; the gradients "
                    "are reduced once, between the two")
            written.update(op.output_names())
        elif op.op_role == OPTIMIZE:
            if first is None:
                first = i
            for n in op.input_names():
                if n in written and n not in grads:
                    grads.append(n)
    return first, grads
