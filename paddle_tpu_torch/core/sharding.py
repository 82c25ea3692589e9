"""The layout engine: a sharded ``CompiledProgram``'s plan, the port's
counterpart of XLA's SPMD partitioner for the IR.

The JAX package hands its annotated program to XLA as one program over
the mesh (``paddle_tpu/transpiler/sharding_transpiler.py``).  Here one
process drives one device, each rank holds its block of every annotated
persistable (``storage_specs``), and ``ShardedPlan.plan`` walks the ops in
order, giving every var a ``Layout`` over the mesh's axes: replicated,
split on dims over axes, or a partial sum over axes.  The batch is this
rank's rows of the data axis, as in ``core/data_parallel.py``, so the
data axis is never in an activation's layout: a parameter sharded over it
(ZeRO-3) is gathered where it is used, and the gradients are reduced over
it once, between the backward ops and the optimizer's.

For each op, ``decide`` names the layouts its inputs must have and the
ones its outputs get; a conversion step (``convert``: all-reduce a
partial sum, all-gather a split, slice a block, or zero a replicated
value on all but one rank of an axis so that it sums as a partial) goes
before it where an input's layout differs, into a var of its own that
later readers share.  What ``decide`` knows:

- ``mul``, ``matmul``, ``fc``: a column-split weight gives a column-split
  output; a row-split weight over an input split on its contraction dim
  gives a partial sum, which is all-reduced before any op reads it, so a
  replicated bias is added once;
- elementwise ops and activations pass the layout through, a broadcast
  operand taking the matching split;
- ``reshape2``/``transpose2`` map the split dim; the program's shape attrs
  are global, so the op runs with the local shape (an attr of the plan,
  never of the program);
- ``flash_attention`` tagged with ``gspmd_head_axis`` (and a
  ``gspmd_batch_axis`` other than the data axis) runs the hand kernels on
  this rank's heads and rows when q, k and v are split so: attention is
  independent per (batch, head), so the split is exact.  Otherwise (a
  head count that the axis does not divide) q, k and v are gathered and
  the kernel runs on every head, as the JAX package's fallback does.

Any other op has its split inputs gathered first: correctness never
depends on the table, only speed does.  A grad op (autograd of its
forward compute on local tensors) takes its forward's decision, its
output cotangents in its forward outputs' layouts (a partial sum's
cotangent replicated), and gives the gradient of a replicated input of
an op sharded over an axis as a partial sum over it (the input gradient
of a column-parallel product).  A gradient's layout is the layout of its
value, so the conjugate of a gather (a slice, or a reduce-scatter of a
partial gradient) or of a slice (a gather) is the conversion its next
reader makes.

At the optimizer: each gradient is converted to its parameter's block
over the non-data axes and reduced over the data axis, reduce-scattered
into its rows where the parameter is sharded on that axis, all-reduced
otherwise (the mean over the data axis's ranks, in one bucket a dtype).
An update runs on the blocks this rank holds, and a ZeRO-3 parameter
stays sharded between steps.  AMP's ``check_finite_and_unscale`` over
sharded gradients gets a flag made global over the world.  Any other
optimize op gets what it reads gathered.  The program is never changed.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import data_parallel as _dp
from paddle_tpu_torch.core.executor import ResolvedOp
from paddle_tpu_torch.core.program import BACKWARD, OPTIMIZE
from paddle_tpu_torch.core.registry import GRAD_SUFFIX, get_op_def, has_op_def
from paddle_tpu_torch.parallel import env as penv


def _entry_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (list, tuple)) else (entry,)


class Layout:
    """Where a var's value lies over the mesh: ``splits`` ((dim, axes),
    the axes major first) and ``partial`` (the axes over which the ranks'
    values sum to it).  No splits and no partial: replicated."""

    __slots__ = ("splits", "partial")

    def __init__(self, splits=(), partial=()):
        self.splits = tuple(sorted((int(d), tuple(a))
                                   for d, a in dict(splits).items() if a))
        self.partial = frozenset(partial)

    def split_of(self, d):
        return dict(self.splits).get(d, ())

    def axes(self):
        return {a for _, axes in self.splits for a in axes}

    def without(self, axis):
        """This layout with ``axis`` gathered."""
        return Layout({d: tuple(a for a in axes if a != axis)
                       for d, axes in self.splits},
                      self.partial - {axis})

    def whole(self):
        """The partial sum resolved, the splits kept."""
        return Layout(self.splits)

    def tag(self):
        s = ",".join(f"{d}:{'.'.join(a)}" for d, a in self.splits)
        p = ".".join(sorted(self.partial))
        return f"@SHARD[{s}|{p}]"

    def __eq__(self, other):
        return isinstance(other, Layout) and self.splits == other.splits \
            and self.partial == other.partial

    def __hash__(self):
        return hash((self.splits, self.partial))

    def __repr__(self):
        return f"Layout({dict(self.splits)}, partial={sorted(self.partial)})"


REP = Layout()


def layout_of_spec(spec):
    return Layout({d: _entry_axes(e) for d, e in enumerate(spec)})


def storage_specs(program, fn, mesh):
    """{persistable: spec} of the persistables that ``fn(name, shape)``
    shards over ``mesh``, as the JAX package reads a rule
    (``paddle_tpu/core/compiler.py:640-690``): an accumulator the rule
    leaves None takes its parameter's rule (the longest parameter name it
    extends); an axis not in the mesh raises; a spec longer than the shape
    raises; a dim the spec does not divide evenly leaves the var
    replicated.  Axes of size 1 are dropped."""
    params = sorted((v.name for v in program.all_parameters()), key=len,
                    reverse=True)
    out = {}
    for v in program.persistables():
        if v.is_data or v.shape is None:
            continue
        shape = tuple(int(d) for d in v.shape)
        ps = fn(v.name, shape)
        if ps is None:
            for pn in params:
                if v.name != pn and v.name.startswith(pn + "_"):
                    ps = fn(pn, shape)
                    break
        if ps is None:
            continue
        spec = tuple(ps)
        if len(spec) > len(shape):
            raise ValueError(f"sharding rule for '{v.name}': spec {ps} has "
                             f"more dims than shape {shape}")
        entries, even = [], True
        for dim, e in zip(shape, spec):
            n = 1
            for a in _entry_axes(e):
                if a not in mesh.shape:
                    raise ValueError(
                        f"sharding rule for '{v.name}': unknown mesh axis "
                        f"'{a}' (mesh axes: {tuple(mesh.axis_names)})")
                n *= mesh.shape[a]
            if dim % n:
                even = False
                break
            entries.append(tuple(a for a in _entry_axes(e)
                                 if mesh.shape[a] > 1))
        if even and any(entries):
            out[v.name] = tuple(entries)
    return out


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def _block_slices(layout, shape, mesh):
    """[(dim, lo, hi)] of this rank's block under ``layout``'s splits."""
    out = []
    for d, axes in layout.splits:
        n, index = 1, 0
        for a in axes:
            index = index * mesh.shape[a] + mesh.axis_index(a)
            n *= mesh.shape[a]
        k = shape[d] // n
        out.append((d, index * k, (index + 1) * k))
    return out


def local_block(t, layout, mesh):
    """This rank's block of the whole ``t`` under ``layout``'s splits."""
    return penv.local_block(t, [layout.split_of(d) for d in range(t.dim())],
                            mesh)


class Shard:
    """This rank's block of a persistable of global ``shape`` under
    ``layout``: the scope's ``ShardedVariable`` holds it
    (``core/data_parallel.py``)."""

    __slots__ = ("layout", "shape", "slices", "mesh")

    def __init__(self, layout, shape, mesh):
        self.layout, self.shape, self.mesh = layout, tuple(shape), mesh
        self.slices = tuple(_block_slices(layout, self.shape, mesh))

    def key(self):
        return (self.shape, self.slices)

    def take(self, t):
        """``t``'s block where ``t`` is the whole value, else ``t``."""
        if tuple(t.shape) == self.shape:
            return local_block(t, self.layout, self.mesh)
        return t

    def describe(self):
        idx = ", ".join(f"dim {d} [{lo}, {hi})" for d, lo, hi in self.slices)
        return f"its block ({idx}) of {self.shape}"


def _gather_dim(t, d, axes, mesh):
    for a in reversed(axes):
        got = penv.collective("all_gather", t, mesh.group(a), mesh.shape[a])
        t = torch.cat(got.unbind(0), dim=d)
    return t


def convert(t, src, dst, mesh):
    """``t`` in layout ``src`` to layout ``dst``: the partial sums that go
    are all-reduced, the splits that change gathered, the new splits
    sliced, and a partial sum that comes is this rank's value on index 0
    of its axis and zeros elsewhere."""
    for a in sorted(src.partial - dst.partial):
        t = penv.collective("all_reduce", t, mesh.group(a), mesh.shape[a])
    now = {}
    for d, axes in src.splits:
        if dst.split_of(d) != axes:
            t = _gather_dim(t, d, axes, mesh)
        else:
            now[d] = axes
    for d, axes in dst.splits:
        if now.get(d) != axes:
            t = local_block(t, Layout({d: axes}), mesh)
    for a in sorted(dst.partial - src.partial):
        if mesh.axis_index(a) != 0:
            t = torch.zeros_like(t)
    return t.contiguous()


def _conversion_type(src, dst):
    """The step's type: a collective's name where it issues one (a host
    step on gloo on the card), else ``slice``."""
    if src.partial - dst.partial:
        return "c_allreduce_sum"
    if any(dst.split_of(d) != axes for d, axes in src.splits):
        return "c_allgather"
    return "slice"


def convert_step(src_name, dst_name, src, dst, mesh):
    return _dp.PlanStep(_conversion_type(src, dst), [src_name], [dst_name],
                        lambda vals: [convert(vals[0], src, dst, mesh)])


def reduce_scatter_dims_step(grads, dims, group, size):
    """Each gradient's mean over the data axis's ranks, of this rank's
    block along its dim in ``dims`` (which the ranks divide evenly): one
    reduce-scatter a dtype, each gradient laid out block-major."""

    def fn(vals):
        out = [None] * len(vals)
        for idxs in _dp._by_dtype(vals):
            cols = [vals[i].movedim(dims[i], 0).contiguous().reshape(
                size, -1) for i in idxs]
            flat = torch.cat(cols, dim=1).reshape(-1)
            mine = penv.collective("reduce_scatter", flat, group,
                                   size) / size
            for i, part in zip(idxs, mine.split([c.shape[1]
                                                 for c in cols])):
                moved = vals[i].movedim(dims[i], 0)
                shape = (moved.shape[0] // size,) + tuple(moved.shape[1:])
                out[i] = part.view(shape).movedim(0, dims[i]).contiguous()
        return out

    return _dp.PlanStep("c_reducescatter", grads, grads, fn)


def all_gather_dims_step(srcs, dsts, dims, group, size):
    """Each block in ``srcs`` gathered whole over the data axis along its
    dim in ``dims`` into ``dsts``: one all-gather a dtype."""

    def fn(vals):
        out = [None] * len(vals)
        for idxs in _dp._by_dtype(vals):
            flats = [vals[i].movedim(dims[i], 0).contiguous().reshape(-1)
                     for i in idxs]
            got = penv.collective("all_gather", torch.cat(flats), group,
                                  size)
            for i, part in zip(idxs, got.split([f.numel() for f in flats],
                                               dim=1)):
                moved = vals[i].movedim(dims[i], 0)
                out[i] = part.reshape((size * moved.shape[0],) + tuple(
                    moved.shape[1:])).movedim(0, dims[i]).contiguous()
        return out

    return _dp.PlanStep("c_allgather", srcs, dsts, fn)


# ---------------------------------------------------------------------------
# the ops' layouts
# ---------------------------------------------------------------------------

_UNARY = frozenset((
    "relu", "tanh", "sigmoid", "gelu", "cast", "scale", "sqrt", "exp",
    "abs", "square", "leaky_relu", "relu6", "swish", "hard_sigmoid",
    "softsign", "dropout", "assign"))
_BINARY = frozenset((
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min"))
# grad ops whose cotangent may stay a partial sum when their forward is
# not sharded (linear in it and cheap: the AMP casts' plumbing)
_PARTIAL_COTANGENT = frozenset(("cast", "scale"))
# an arbitrary extent for an unknown (batch) dim in reshape2's mapping
_SENTINEL = 7919


def _axes_size(axes, mesh):
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


class Decision:
    """What an op needs and gives: ``want`` {slot: [Layout]} of its inputs,
    ``outs`` {slot: [Layout]} of its outputs (a slot left out is
    replicated), ``attrs`` the attrs it runs with (None: its own)."""

    __slots__ = ("want", "outs", "attrs")

    def __init__(self, want, outs=None, attrs=None):
        self.want, self.outs, self.attrs = want, outs or {}, attrs


def _replicated(ins):
    return Decision({s: [REP] * len(ls) for s, ls in ins.items()})


def decide(op_type, attrs, ins, shapes, mesh):
    """The layouts ``op_type`` runs in, from its inputs' layouts ``ins``
    ({slot: [Layout]}, the data axis gathered already) and their declared
    shapes ``shapes`` ({slot: [shape or None]})."""
    if not any(l != REP for ls in ins.values() for l in ls):
        return _replicated(ins)
    rule = _RULES.get(op_type)
    got = rule(attrs, ins, shapes, mesh) if rule is not None else None
    return got if got is not None else _replicated(ins)


def _unary(attrs, ins, shapes, mesh):
    if set(ins) != {"X"} or len(ins["X"]) != 1:
        return None
    lay = ins["X"][0].whole()
    return Decision({"X": [lay]}, {"Out": [lay], "Mask": [lay]})


def _binary(attrs, ins, shapes, mesh):
    xs, ys = shapes["X"][0], shapes["Y"][0]
    if xs is None or ys is None or len(ys) > len(xs):
        return None
    lx = ins["X"][0].whole()
    axis = attrs.get("axis", -1)
    off = axis if axis is not None and axis >= 0 else len(xs) - len(ys)
    ysplit = {}
    for d, axes in lx.splits:
        yd = d - off
        if 0 <= yd < len(ys) and ys[yd] != 1:
            ysplit[yd] = axes
    return Decision({"X": [lx], "Y": [Layout(ysplit)]}, {"Out": [lx]})


def _sum(attrs, ins, shapes, mesh):
    lays = ins["X"]
    if all(l == lays[0] for l in lays):
        return Decision({"X": list(lays)}, {"Out": [lays[0]]})
    if all(l.splits == lays[0].splits for l in lays):
        part = frozenset().union(*(l.partial for l in lays))
        lay = Layout(lays[0].splits, part)
        return Decision({"X": [lay] * len(lays)}, {"Out": [lay]})
    return None


def _matmul_layouts(lx, ly, xnc, nx):
    """(want X, want Y, out) of X [lead..., contraction...] (``nx`` dims,
    the lead ones ``[:xnc]``) times a 2-D Y [K, N]: a row split of Y over
    X split on its one contraction dim gives a partial sum, a column
    split a split output; X's lead splits pass through."""
    row, col = ly.split_of(0), ly.split_of(1)
    lead = {d: a for d, a in lx.splits if d < xnc}
    if set(a for axes in lead.values() for a in axes) & (set(row) | set(col)):
        lead = {}
    if row and nx - xnc == 1:
        wx = Layout({**lead, xnc: row})
        out = Layout({**lead, **({xnc: col} if col else {})}, row)
        return wx, Layout({0: row, 1: col}), out
    wy = Layout({1: col})
    return Layout(lead), wy, Layout({**lead, **({xnc: col} if col else {})})


def _mul(attrs, ins, shapes, mesh):
    xs, ys = shapes["X"][0], shapes["Y"][0]
    if xs is None or ys is None or len(ys) != 2 or \
            attrs.get("y_num_col_dims", 1) != 1:
        return None
    wx, wy, out = _matmul_layouts(ins["X"][0].whole(), ins["Y"][0].whole(),
                                  attrs.get("x_num_col_dims", 1), len(xs))
    return Decision({"X": [wx], "Y": [wy]}, {"Out": [out]})


def _matmul(attrs, ins, shapes, mesh):
    xs, ys = shapes["X"][0], shapes["Y"][0]
    if xs is None or ys is None or len(ys) != 2 or len(xs) < 2 or \
            attrs.get("transpose_X") or attrs.get("transpose_Y"):
        return None
    wx, wy, out = _matmul_layouts(ins["X"][0].whole(), ins["Y"][0].whole(),
                                  len(xs) - 1, len(xs))
    return Decision({"X": [wx], "Y": [wy]}, {"Out": [out]})


def _fc(attrs, ins, shapes, mesh):
    xs, ws = shapes["Input"][0], shapes["W"][0]
    if xs is None or ws is None or len(ws) != 2:
        return None
    xnc = attrs.get("in_num_col_dims", 1)
    # a row split's partial sums cannot take the bias and the activation
    lw = Layout({1: ins["W"][0].split_of(1)})
    wx, wy, out = _matmul_layouts(ins["Input"][0].whole(), lw, xnc,
                                  len(xs))
    want = {"Input": [wx], "W": [wy]}
    if "Bias" in ins:
        want["Bias"] = [Layout({0: wy.split_of(1)})]
    return Decision(want, {"Out": [out]})


def _reshape2(attrs, ins, shapes, mesh):
    xs = shapes["X"][0]
    lx = ins["X"][0].whole()
    if xs is None or sum(1 for d in xs if d < 0) > 1:
        return None
    ix = [_SENTINEL if d < 0 else int(d) for d in xs]
    total = 1
    for d in ix:
        total *= d
    target = [ix[i] if d == 0 else int(d)
              for i, d in enumerate(attrs["shape"])]
    known = 1
    for d in target:
        if d > 0:
            known *= d
    if target.count(-1) > 1 or (target.count(-1) and total % known):
        return None
    out = [total // known if d == -1 else d for d in target]
    local = list(attrs["shape"])
    splits = {}
    for d, axes in lx.splits:
        n = _axes_size(axes, mesh)
        pre = 1
        for e in ix[:d]:
            pre *= e
        j, acc = 0, 1
        while j < len(out) and acc < pre:
            acc *= out[j]
            j += 1
        if acc != pre or j >= len(out) or out[j] % n or \
                out[j] == _SENTINEL:
            return None
        if local[j] > 0:
            local[j] //= n
        elif local[j] == 0 and j != d:
            local[j] = out[j] // n
        splits[j] = axes
    out_lay = Layout(splits)
    attrs = dict(attrs, shape=local)
    return Decision({"X": [lx]}, {"Out": [out_lay]}, attrs)


def _transpose(attrs, ins, shapes, mesh):
    lx = ins["X"][0].whole()
    perm = [int(a) for a in attrs["axis"]]
    return Decision({"X": [lx]}, {"Out": [Layout(
        {perm.index(d): axes for d, axes in lx.splits})]})


def _flash(attrs, ins, shapes, mesh):
    lays = [ins[s][0].whole() for s in ("Q", "K", "V")]
    allowed = {1: attrs.get("gspmd_head_axis") or None,
               0: attrs.get("gspmd_batch_axis") or None}
    lq = lays[0]
    if any(l != lq for l in lays) or not all(
            axes == (allowed.get(d),) for d, axes in lq.splits):
        return None      # gathered: the kernel on every head
    return Decision({s: [lq] for s in ("Q", "K", "V")}, {"Out": [lq]})


_RULES = {
    **dict.fromkeys(_UNARY, _unary), **dict.fromkeys(_BINARY, _binary),
    "sum": _sum, "mul": _mul, "matmul": _matmul, "fc": _fc,
    "reshape2": _reshape2, "transpose2": _transpose,
    "transpose": _transpose, "flash_attention": _flash,
}


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

class LocalOp:
    """An op on this rank's blocks: its inputs read through ``renames``
    (the converted vars), computed with ``attrs`` (None: the op's own),
    its outputs written under ``out_renames`` (a persistable updated in
    another layout than the one it is kept in, until its conversion);
    ``ResolvedOp``'s contract."""

    __slots__ = ("rop", "op", "renames", "attrs", "out_renames")

    def __init__(self, rop, renames, attrs, out_renames=None):
        self.rop, self.op = rop, rop.op
        self.renames, self.attrs = renames, attrs
        self.out_renames = out_renames or {}

    @property
    def op_def(self):
        return self.rop.op_def

    @property
    def outputs(self):
        return self.rop.outputs

    def input_names(self):
        return [self.renames.get(n, n) for n in self.rop.input_names()]

    def output_names(self):
        return [self.out_renames.get(n, n) for n in self.rop.output_names()]

    def gather(self, get):
        return self.rop.gather(lambda n: get(self.renames.get(n, n)))

    def compute(self, ins, device):
        if self.attrs is None:
            return self.rop.compute(ins, device)
        try:
            return self.rop.op_def.compute(ins, self.attrs, device)
        except Exception as e:
            raise RuntimeError(f"error running op {self.op.type} "
                               f"({self.op!r}) on its blocks: {e}") from e

    def scatter(self, outs, put):
        self.rop.scatter(outs, lambda n, v: put(self.out_renames.get(n, n),
                                                v))


class ShardedPlan:
    """The plan of a program whose persistables ``specs`` shards over
    ``mesh`` ({name: spec}, ``storage_specs``); ``plan(ops)`` gives the
    steps, ``final`` every var's layout after them."""

    def __init__(self, program, mesh, data_axis, specs):
        self.program, self.mesh, self.data_axis = program, mesh, data_axis
        self.storage = {n: layout_of_spec(s) for n, s in specs.items()}
        self.final = {}
        self._block = program.global_block()

    # -- helpers -----------------------------------------------------------
    def _data(self):
        """(group, size) of the data axis, None where it has one rank."""
        a = self.data_axis
        if a not in self.mesh.shape or self.mesh.shape[a] == 1 or \
                self.mesh.group(a) is None:
            return None
        return self.mesh.group(a), self.mesh.shape[a]

    def _shape(self, name):
        v = self._block.vars.get(name)
        if v is None or v.shape is None:
            return None
        return tuple(int(d) for d in v.shape)

    def _cur(self, name):
        return self._lay.get(name, REP)

    def _read(self, name, want, pre):
        """The env name holding ``name`` in layout ``want``; a conversion
        into a var of its own goes into ``pre`` where none holds it."""
        if name in self._pending:
            pre += self._flush([name])
        cur = self._cur(name)
        if cur == want:
            return name
        versions = self._versions.setdefault(name, {})
        if want not in versions:
            versions[want] = name + want.tag()
            pre.append(convert_step(name, versions[want], cur, want,
                                    self.mesh))
        return versions[want]

    def _write(self, name, lay):
        self._lay[name] = lay
        self._versions.pop(name, None)

    def _in_place(self, name, lay, steps):
        """``name`` converted to ``lay`` under its own name."""
        cur = self._cur(name)
        if cur != lay:
            steps.append(convert_step(name, name, cur, lay, self.mesh))
            self._write(name, lay)

    # -- the walk ----------------------------------------------------------
    def plan(self, ops, passthrough):
        """[(op or None, step)]: a program op with the step that runs it
        (None for one ``passthrough(op)`` leaves to the caller), or a plan
        step (None, step)."""
        self._lay, self._versions = dict(self.storage), {}
        self._pending = {}
        self._update, self._update_of_grad = self._update_layouts(ops)
        first, grads = _dp.step_grads(ops)
        out = []
        for i, op in enumerate(ops):
            if i == first:
                out += [(None, s) for s in self._reduce_grads(grads)]
            if passthrough(op) or not has_op_def(op.type):
                out.append((op, None))
                for names in op.outputs.values():
                    for n in names:
                        self._write(n, REP)
                continue
            if get_op_def(op.type).host_only:
                # a host op reads whole values
                pre, step, post = self._emit(op, ResolvedOp(op),
                                             Decision({}))
            else:
                pre, step, post = self._op(op)
            out += [(None, s) for s in pre]
            out.append((op, step))
            out += [(None, s) for s in post]
        out += [(None, s) for s in self._flush(list(self._pending))]
        self.final = dict(self._lay)
        return out

    def _update_layouts(self, ops):
        """({parameter: the layout its update runs in}, the same by
        gradient): the parameter's own layout where it is sharded, else
        that of an accumulator of its shape that is (ZeRO 1-2: the
        parameter's rows are updated and gathered back), else
        replicated."""
        update, by_grad = {}, {}
        for op in ops:
            params = op.inputs.get("Param")
            if op.op_role != OPTIMIZE or not params or "Grad" not in \
                    op.inputs:
                continue
            for i, p in enumerate(params):
                lay = self.storage.get(p)
                for slot, names in op.inputs.items():
                    if lay is not None:
                        break
                    if slot not in ("Param", "Grad") and \
                            len(names) == len(params) and \
                            names[i] in self.storage and \
                            self._shape(names[i]) == self._shape(p):
                        lay = self.storage[names[i]]
                update.setdefault(p, lay or REP)
                by_grad.setdefault(op.inputs["Grad"][i], update[p])
        return update, by_grad

    def _flush(self, names):
        """The pending conversions of ``names`` (persistables updated in
        another layout than they are kept in) into their own layouts: one
        bucket for those gathered over the data axis alone, a step each
        for the rest."""
        steps, bucket, data = [], [], self._data()
        for n in names:
            tmp, lay, store = self._pending.pop(n)
            dims = [d for d, axes in lay.splits
                    if axes == (self.data_axis,)]
            if data is not None and not lay.partial and len(dims) == 1 \
                    and lay.without(self.data_axis) == store:
                bucket.append((tmp, n, dims[0]))
            else:
                steps.append(convert_step(tmp, n, lay, store, self.mesh))
            self._write(n, store)
        if bucket:
            srcs, dsts, dims = (list(t) for t in zip(*bucket))
            steps.append(all_gather_dims_step(srcs, dsts, dims, *data))
        return steps

    def _op(self, op):
        if op.op_role == OPTIMIZE:
            dec = self._optimize(op)
        elif op.type.endswith("_grad") and has_op_def(op.type[:-5]) and \
                op.op_role == BACKWARD:
            dec = self._grad(op)
        else:
            ins = {s: [self._cur(n).without(self.data_axis) for n in names]
                   for s, names in op.inputs.items()}
            shapes = {s: [self._shape(n) for n in names]
                      for s, names in op.inputs.items()}
            dec = decide(op.type, op.attrs, ins, shapes, self.mesh)
        wanted = {}
        for slot, names in op.inputs.items():
            for n, w in zip(names, dec.want.get(slot, [REP] * len(names))):
                if wanted.setdefault(n, w) != w:
                    # one var wanted in two layouts: whole for both
                    dec = Decision({})
                    break
        return self._emit(op, ResolvedOp(op), dec)

    def _emit(self, op, rop, dec):
        pre, renames, post = [], {}, []
        for slot, names in op.inputs.items():
            lays = dec.want.get(slot, [REP] * len(names))
            for n, w in zip(names, lays):
                renames[n] = self._read(n, w, pre)
        out_renames = {}
        for slot, names in op.outputs.items():
            lays = dec.outs.get(slot, [REP] * len(names))
            for n, lay in zip(names, lays):
                self._pending.pop(n, None)
                store = self.storage.get(n)
                if store is None and self._is_persistable(n):
                    store = REP
                if store is not None and lay != store:
                    # kept in ``store``: written aside, converted at the
                    # plan's end or before its next reader
                    tmp = out_renames[n] = n + lay.tag()
                    self._pending[n] = (tmp, lay, store)
                    self._write(tmp, lay)
                    continue
                self._write(n, lay)
        if op.type == "check_finite_and_unscale":
            post += self._found_inf(op)
        step = rop if dec.attrs is None and not out_renames and all(
            k == v for k, v in renames.items()) else \
            LocalOp(rop, renames, dec.attrs, out_renames)
        return pre, step, post

    def _is_persistable(self, name):
        v = self._block.vars.get(name)
        return v is not None and v.persistable

    def _grad(self, op):
        """A grad op: its forward's decision on the forward inputs' layouts,
        its cotangents in the forward outputs' layouts, its input gradients
        partial over the axes its forward is sharded on."""
        fwd = get_op_def(op.type[:-5])
        fslots = [s for s in fwd.inputs if s in op.inputs]
        ins = {s: [self._cur(n).without(self.data_axis)
                   for n in op.inputs[s]] for s in fslots}
        shapes = {s: [self._shape(n) for n in op.inputs[s]] for s in fslots}
        fdec = decide(fwd.type, op.attrs, ins, shapes, self.mesh)
        sharded = set()
        for ls in list(fdec.want.values()) + list(fdec.outs.values()):
            for l in ls:
                sharded |= l.axes() | l.partial
        want = {s: fdec.want.get(s, [REP] * len(op.inputs[s]))
                for s in fslots}
        cot_partial = set()
        for s in fwd.outputs:
            names = op.inputs.get(s + GRAD_SUFFIX)
            if names is None:
                if s in op.inputs:
                    want[s] = fdec.outs.get(s, [REP] * len(op.inputs[s]))
                continue
            outs = fdec.outs.get(s, [REP] * len(names))
            lays = []
            for n, lo in zip(names, outs):
                keep = self._cur(n).partial - {self.data_axis} \
                    if fwd.type in _PARTIAL_COTANGENT and not sharded \
                    else frozenset()
                cot_partial |= keep
                lays.append(Layout(lo.splits, keep))
            want[s + GRAD_SUFFIX] = lays
        outs = {}
        for s in fslots:
            if s + GRAD_SUFFIX not in op.outputs:
                continue
            outs[s + GRAD_SUFFIX] = [
                Layout(w.splits, (sharded | cot_partial) - w.axes())
                for w in want[s]]
        return Decision(want, outs, fdec.attrs)

    def _optimize(self, op):
        """An optimize op: a parameter's update on the blocks this rank
        holds (each input of its parameter's shape in its parameter's
        layout), AMP's check on the gradients as they lie, any other op
        on whole values."""
        params = op.inputs.get("Param")
        if params and "Grad" in op.inputs:
            lays = [self._update[p] for p in params]
            pshapes = [self._shape(p) for p in params]

            def per(slots):
                got = {}
                for slot, names in slots.items():
                    if len(names) != len(params):
                        got[slot] = [REP] * len(names)
                        continue
                    got[slot] = [lays[i] if slot in ("Grad", "Param",
                                                     "ParamOut")
                                 or self._shape(n) == pshapes[i] else REP
                                 for i, n in enumerate(names)]
                return got

            return Decision(per(op.inputs), per(op.outputs))
        if op.type == "check_finite_and_unscale":
            xs = [self._cur(n) for n in op.inputs["X"]]
            return Decision({"X": xs, "Scale": [REP]}, {"Out": list(xs)})
        return Decision({s: [REP] * len(ns) for s, ns in op.inputs.items()})

    def _found_inf(self, op):
        """AMP's flag over gradients some of which this rank holds blocks
        of: the max over the world, the unscaled gradients zeroed where it
        is set (``data_parallel.found_inf_step``)."""
        if not any(self._cur(n) != REP for n in op.inputs["X"]) or \
                penv.world_size() == 1:
            return []
        import torch.distributed as dist

        zero_on_inf = get_op_def(op.type).canonical_attrs(
            op.attrs)["zero_on_inf"]
        return [_dp.found_inf_step(op.outputs["FoundInfinite"][0],
                                   op.outputs["Out"], zero_on_inf,
                                   dist.group.WORLD, penv.world_size())]

    def _reduce_grads(self, grads):
        """Between the backward and the optimizer: each gradient in its
        parameter's update layout over the non-data axes, then its mean
        over the data axis, reduce-scattered into the update's rows where
        that is sharded on the data axis (alone on a dim), all-reduced
        otherwise."""
        steps, data = [], self._data()
        plain, scatter, dims, whole = [], [], [], []
        for g in grads:
            target = self._update_of_grad.get(g, REP)
            ax = self.data_axis
            dim = next((d for d, axes in target.splits if ax in axes), None)
            if dim is not None and (data is None or
                                    target.split_of(dim) != (ax,)):
                whole.append((g, target))  # composed with another axis
                continue
            self._in_place(g, target.without(ax), steps)
            if data is None:
                continue
            if dim is None:
                plain.append(g)
            else:
                scatter.append(g)
                dims.append(dim)
            self._write(g, target)
        if data is not None:
            group, size = data
            if plain:
                steps.append(_dp.all_reduce_step(plain, group, size))
            if scatter:
                steps.append(reduce_scatter_dims_step(scatter, dims, group,
                                                      size))
        for g, target in whole:
            self._in_place(g, REP, steps)
            if data is not None:
                steps.append(_dp.all_reduce_step([g], *data))
            self._in_place(g, target, steps)
        return steps
