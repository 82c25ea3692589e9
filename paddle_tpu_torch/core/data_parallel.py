"""Data parallelism of ``CompiledProgram``: the gradient collectives and
ZeRO's sharded updates as steps of the plan, and the step's fetch rules.

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
- Under ZeRO (``with_sharding_rules`` with ``zero_sharding_rules``) a
  parameter whose accumulators the rule shards on dim 0 is updated in
  rows: its gradient is reduce-scattered into this rank's rows (one
  bucket a dtype), the optimize op runs on those rows of the parameter
  and of its accumulators, which the scope holds as this rank's rows
  only, and the updated rows are all-gathered back into the parameter.
  Rows are cut in ``ceil(R / ranks)`` blocks, the last ones shorter.
  AMP's ``check_finite_and_unscale`` then sees this rank's rows of those
  gradients only, so its flag is made global (a max over the ranks) and
  the gradients it unscaled are zeroed where any rank overflowed, as the
  check on the whole gradients does; any other optimize op that reads a
  sharded gradient is refused.  The scope keeps no rows: its entry of a
  sharded accumulator is a ``ShardedVariable``, which refuses a read.
- The program is never changed: these are steps of the plan only.

Every step speaks ``ResolvedOp``'s contract (``input_names``,
``output_names``, ``gather``, ``compute``, ``scatter``), so the plan runs,
captures and replays them as it does an op.
"""

from __future__ import annotations

import math
import types

import torch

from paddle_tpu_torch.core.program import BACKWARD, OPTIMIZE
from paddle_tpu_torch.core.scope import Variable
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.parallel.zero import is_dim0_spec

GSPMD_ITEM = "parallel/gspmd.py, ROADMAP Queue 1 item 5"


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


class ZeroRows:
    """This rank's rows of one parameter of ``rows_total`` rows: the block
    ``[lo, hi)`` of ``ceil(rows_total / size)`` rows at ``index``."""

    __slots__ = ("rows_total", "block", "lo", "hi", "accumulators")

    def __init__(self, rows_total, size, index, accumulators):
        self.rows_total = rows_total
        self.block = max(1, math.ceil(rows_total / size))
        self.lo = min(rows_total, index * self.block)
        self.hi = min(rows_total, (index + 1) * self.block)
        self.accumulators = tuple(accumulators)


def rows_name(param):
    return param + "@ZERO_ROWS"


def _padded_rows(t, rows):
    """``t`` with zero rows appended up to ``rows`` rows."""
    if t.shape[0] == rows:
        return t
    pad = torch.zeros((rows - t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


def reduce_scatter_step(grads, rows, group, size):
    """Each gradient's mean over the ranks, of this rank's rows only: one
    reduce-scatter a dtype over the gradients padded to ``size`` blocks,
    laid out block-major so block r of every gradient lands on rank r."""

    def fn(vals):
        out = [None] * len(vals)
        for idxs in _by_dtype(vals):
            cols = []
            for i in idxs:
                r = rows[i]
                g = _padded_rows(vals[i], r.block * size)
                cols.append(g.reshape(size, -1))
            flat = torch.cat(cols, dim=1).reshape(-1)
            mine = penv.collective("reduce_scatter", flat, group,
                                   size) / size
            widths = [c.shape[1] for c in cols]
            for i, part in zip(idxs, mine.split(widths)):
                r = rows[i]
                block = part.view((r.block,) + tuple(vals[i].shape[1:]))
                out[i] = block[:r.hi - r.lo]
        return out

    return PlanStep("c_reducescatter", grads, grads, fn)


def all_gather_step(params, rows, group, size):
    """Every rank's updated rows gathered back into the whole parameters:
    one all-gather a dtype."""
    names = [rows_name(p) for p in params]

    def fn(vals):
        out = [None] * len(vals)
        for idxs in _by_dtype(vals):
            flats = [_padded_rows(vals[i], rows[i].block).reshape(-1)
                     for i in idxs]
            got = penv.collective("all_gather", torch.cat(flats), group,
                                  size)
            for i, part in zip(idxs, got.split(
                    [f.numel() for f in flats], dim=1)):
                r = rows[i]
                full = part.reshape((size * r.block,)
                                    + tuple(vals[i].shape[1:]))
                out[i] = full[:r.rows_total]
        return out

    return PlanStep("c_allgather", names, params, fn)


def gather_rows(t, r, group, size):
    """A ZeRO-sharded persistable's whole value from every rank's rows."""
    got = penv.collective("all_gather", _padded_rows(t, r.block), group,
                          size)
    return got.reshape((size * r.block,) + tuple(t.shape[1:]))[
        :r.rows_total]


def found_inf_step(found, grads, zero_on_inf, group, size):
    """AMP's overflow flag ``found`` (written by ``check_finite_and_unscale``
    on this rank's rows of the sharded gradients) made the max over the
    ranks, and with ``zero_on_inf`` the unscaled ``grads`` zeroed where it
    is set: each rank's check zeroed them only where its own rows
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
    """A read, outside the compiled program that shards it, of a ZeRO-sharded
    accumulator: no rank holds its whole value."""


class ShardedVariable(Variable):
    """The scope's entry of a ZeRO-sharded accumulator while a data-parallel
    ``CompiledProgram`` holds this rank's rows of it (``rows``, the block
    ``r``).  Reading it raises ``ZeroShardedError``: the rows differ by rank
    and no rank holds the whole.  A whole value set in its place is read
    back as it is, and the program shards it anew at its next run."""

    def __init__(self, name, rows, r):
        super().__init__(name)
        self.rows, self.r = rows, r

    def holds(self, r):
        """Whether the entry still holds the rows of block ``r``."""
        return self.value is None and (self.r.rows_total, self.r.lo,
                                       self.r.hi) == (r.rows_total, r.lo,
                                                      r.hi)

    def get(self):
        if self.value is None:
            raise ZeroShardedError(
                f"'{self.name}' is ZeRO-sharded: this rank holds rows "
                f"[{self.r.lo}, {self.r.hi}) of {self.r.rows_total} in the "
                "data-parallel CompiledProgram that updates it, and no rank "
                "holds the whole value; fetch it through that program (the "
                "fetch gathers the rows), or read its rows with "
                "CompiledProgram.sharded_state()")
        return self.value


class ZeroOpt:
    """An optimize op on this rank's rows: its Param input sliced to the
    rows of each sharded parameter (its Grad and accumulators already are
    those rows), its ParamOut written under ``rows_name``."""

    __slots__ = ("rop", "op", "rows")

    def __init__(self, rop, rows):
        self.rop, self.op, self.rows = rop, rop.op, rows

    def input_names(self):
        return self.rop.input_names()

    def _out_name(self, slot, n):
        return rows_name(n) if slot == "ParamOut" and n in self.rows else n

    def output_names(self):
        return [self._out_name(slot, n) for slot, names in self.rop.outputs
                for n in names]

    def gather(self, get):
        ins = self.rop.gather(get)
        names = self.op.inputs["Param"]
        p = ins["Param"]
        if isinstance(p, list):
            ins["Param"] = [self._slice(n, v) for n, v in zip(names, p)]
        else:
            ins["Param"] = self._slice(names[0], p)
        return ins

    def _slice(self, name, v):
        r = self.rows.get(name)
        return v if r is None else v[r.lo:r.hi]

    def compute(self, ins, device):
        return self.rop.compute(ins, device)

    def scatter(self, outs, put):
        for slot, names in self.rop.outputs:
            if slot not in outs:
                continue
            vals = outs[slot]
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for n, v in zip(names, vals):
                put(self._out_name(slot, n), v)


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


def _slot_name(op, slot, i):
    names = op.inputs.get(slot) or []
    if len(names) == len(op.inputs["Param"]):
        return names[i]
    return names[0] if len(names) == 1 else None


def zero_layout(program, fn, axis):
    """{parameter: its sharded accumulators} under the rule ``fn``; raises
    ``NotImplementedError`` naming the gspmd item for a rule this port
    cannot run: a sharded parameter (ZeRO stage 3), a spec other than dim
    0 over ``axis``, a sharded accumulator not row for row its
    parameter's, or a sharded persistable that is no optimizer state."""
    from paddle_tpu_torch.core.registry import get_op_def

    block = program.global_block()
    params = {v.name for v in program.all_parameters()}
    specs = {}
    for v in program.persistables():
        if v.is_data or v.shape is None:
            continue
        shape = tuple(int(d) for d in v.shape)
        spec = fn(v.name, shape)
        if spec is None:
            continue
        if v.name in params:
            raise NotImplementedError(
                f"with_sharding_rules: parameter '{v.name}' is sharded "
                f"({spec}); sharding parameters (ZeRO stage 3, tensor "
                f"layouts) waits for {GSPMD_ITEM}")
        if not is_dim0_spec(spec, axis):
            raise NotImplementedError(
                f"with_sharding_rules: '{v.name}' takes {spec}; the port "
                f"runs ZeRO's dim 0 over '{axis}' only, other partition "
                f"specs wait for {GSPMD_ITEM}")
        specs[v.name] = shape
    layout, claimed = {}, set()
    for op in block.ops:
        if op.op_role != OPTIMIZE or "Param" not in op.inputs \
                or "Grad" not in op.inputs:
            continue
        slots = [s for s in get_op_def(op.type).in_place.values()
                 if s not in ("Param", "Grad")]
        for i, p in enumerate(op.inputs["Param"]):
            pshape = tuple(int(d) for d in block.var(p).shape)
            accs = [a for a in (_slot_name(op, s, i) for s in slots)
                    if a is not None and a in specs]
            for a in accs:
                if specs[a] != pshape:
                    raise NotImplementedError(
                        f"with_sharding_rules: accumulator '{a}' "
                        f"{specs[a]} is sharded but its parameter '{p}' is "
                        f"{pshape}; waits for {GSPMD_ITEM}")
            if accs:
                same = [a for a in (_slot_name(op, s, i) for s in slots)
                        if a is not None and tuple(int(d) for d in
                                                   block.var(a).shape)
                        == pshape]
                layout[p] = tuple(dict.fromkeys(same))
                claimed.update(same)
    stray = sorted(set(specs) - claimed)
    if stray:
        raise NotImplementedError(
            f"with_sharding_rules: {stray} are sharded but are no "
            f"optimizer state of a parameter; waits for {GSPMD_ITEM}")
    return layout
