"""The sharding front-end: one mesh plan, PartitionSpec annotations on the
Program IR, and the passes that write them.

Counterpart of ``paddle_tpu/parallel/gspmd.py``.  The JAX package hands
the annotated program to XLA's SPMD partitioner as one program over a
multi-device mesh.  Here one process drives one device: ``MeshPlan``
builds a ``parallel.env.Mesh`` over the world's ranks, and
``CompiledProgram`` (``core/sharding.py``) gives each rank its block of
every annotated var and puts the collectives at the layout boundaries.
The passes and their names are the JAX package's:

- ``annotate_zero3``: ZeRO-3 as a spec.  Parameters and optimizer state
  of at least ``min_size`` elements take the data axis on their first
  free dim that it divides; gathered where they are used.
- ``annotate_tp_transformer``: the Megatron column/row splits of the
  transformer models' fc weights, keyed on their ``param_prefix`` name
  grammar.
- ``annotate_tp_inference``: column-only splits of an inference
  program's fc weights, with the chain guard (to a fixpoint) that keeps
  every contraction full-width.
- ``tag_attention_ops``: ``gspmd_batch_axis``/``gspmd_head_axis`` on
  every flash_attention op and its grad, so the kernel runs on each
  rank's rows and heads.
- ``carve_slices``: a flat device list cut into plan-sized slices.

Annotations live on ``VarDesc.sharding`` (serialised with the program,
hashed into the compiled program's fingerprint).  Everything is gated by
the typed ``gspmd`` flag (``transpiler.shard_program``).
"""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.parallel.zero import PartitionSpec

__all__ = ["MeshPlan", "annotate_var", "annotate_zero3",
           "annotate_tp_transformer", "annotate_tp_inference",
           "tag_attention_ops", "partition_spec_of", "carve_slices"]


class MeshPlan:
    """Named parallel axes over the world's ranks.

    ``MeshPlan(dp=4, tp=2)`` is a (4, 2, 1) mesh with axes ("dp", "tp",
    "pp").  Size-1 axes are kept (a spec naming them shards by a factor of
    1), so one annotated program runs on any plan shape; extra axes ride
    along by name."""

    def __init__(self, dp=1, tp=1, pp=1, extra=None, data_axis="dp"):
        axes = {"dp": int(dp), "tp": int(tp), "pp": int(pp)}
        for name, size in (extra or {}).items():
            if name in axes:
                raise ValueError(f"duplicate mesh axis '{name}'")
            axes[name] = int(size)
        for name, size in axes.items():
            if size < 1:
                raise ValueError(f"mesh axis '{name}': size {size} < 1")
        if data_axis not in axes:
            raise ValueError(f"data_axis '{data_axis}' not an axis "
                             f"of {tuple(axes)}")
        self.axes = axes
        self.data_axis = data_axis

    @property
    def axis_names(self):
        return tuple(self.axes)

    @property
    def shape(self):
        return tuple(self.axes.values())

    def size(self):
        n = 1
        for s in self.axes.values():
            n *= s
        return n

    def axis_size(self, name) -> int:
        """Size of an axis; 1 for an axis the plan does not know."""
        return int(self.axes.get(name, 1))

    def __repr__(self):
        return "MeshPlan(%s)" % ", ".join(
            f"{k}={v}" for k, v in self.axes.items())

    def __eq__(self, other):
        return isinstance(other, MeshPlan) and \
            other.axes == self.axes and other.data_axis == self.data_axis

    @staticmethod
    def from_mesh(mesh, data_axis=None):
        """The plan of a ``parallel.env.Mesh`` (its ``shape`` is {axis:
        size})."""
        plan = MeshPlan.__new__(MeshPlan)
        plan.axes = {n: int(mesh.shape[n]) for n in mesh.axis_names}
        plan.data_axis = data_axis or (
            "dp" if "dp" in plan.axes else mesh.axis_names[0])
        return plan

    def to_dict(self):
        return {"axes": dict(self.axes), "data_axis": self.data_axis}

    @staticmethod
    def from_dict(d):
        plan = MeshPlan.__new__(MeshPlan)
        plan.axes = {k: int(v) for k, v in d["axes"].items()}
        plan.data_axis = d.get("data_axis", "dp")
        return plan

    def build_mesh(self, devices=None):
        """A ``parallel.env.Mesh`` with this plan's axes over the world's
        ranks (one process a device; ``devices``, when given, one a rank).
        The world must be the plan's size."""
        from paddle_tpu_torch.parallel import env as penv

        world = penv.world_size() if devices is None else len(devices)
        if world != self.size():
            raise ValueError(
                f"{self!r} needs {self.size()} devices, have {world}; size "
                "the plan to the world (e.g. dp = world // tp) and start "
                "one process a device with python -m "
                f"paddle_tpu_torch.launch --nproc_per_node {self.size()}")
        return penv.make_mesh(shape=self.shape, axis_names=self.axis_names,
                              devices=devices)

    def spec(self, *entries):
        """A PartitionSpec of per-dim entries, checked against the plan's
        axis names."""
        for e in entries:
            for a in (e if isinstance(e, (list, tuple)) else (e,)):
                if a is not None and a not in self.axes:
                    raise ValueError(f"spec axis '{a}' not in {self!r}")
        return PartitionSpec(*entries)


# ---------------------------------------------------------------------------
# annotation passes
# ---------------------------------------------------------------------------

def annotate_var(var, spec):
    """Write a PartitionSpec-like annotation onto a VarDesc (an entry a
    dim: None, an axis name or a tuple of axis names)."""
    return var.set_sharding(spec)


def _entry_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (list, tuple)) else (entry,)


def _shard_factor(plan, entry):
    n = 1
    for a in _entry_axes(entry):
        n *= plan.axis_size(a)
    return n


def partition_spec_of(var, plan, shape=None) -> Optional[PartitionSpec]:
    """The var's annotation as a PartitionSpec, checked against the plan:
    an unknown axis raises; a dim the spec does not divide evenly (or a
    spec longer than the shape) gives None, replicated.  ``shape``
    overrides the var's declared shape."""
    if getattr(var, "sharding", None) is None:
        return None
    spec = var.sharding
    shape = var.shape if shape is None else tuple(shape)
    if shape is not None and len(spec) > len(shape):
        return None
    for entry in spec:
        for a in _entry_axes(entry):
            if a not in plan.axes:
                raise ValueError(
                    f"var '{var.name}': sharding axis '{a}' not in "
                    f"{plan!r}")
    if shape is not None:
        for dim, entry in zip(shape, spec):
            n = _shard_factor(plan, entry)
            if n > 1 and (dim is None or int(dim) < 0 or
                          int(dim) % n != 0):
                return None
    return PartitionSpec(*spec)


def annotate_zero3(program, plan, min_size=2 ** 12, axis="dp",
                   params=True, optimizer_state=True):
    """ZeRO-3 as a spec: parameters (stage 3) and optimizer state take
    ``axis`` on their first free dim that it divides; tensors of fewer
    than ``min_size`` elements stay replicated.  Composes with tp: a dim
    that already carries an axis is skipped, so a row-parallel ("tp",
    None) weight becomes ("tp", "dp").  An accumulator of its parameter's
    shape first takes the parameter's layout.  Optimizer state is found
    exactly (``parallel.zero.collect_optimizer_state``), so call this
    after ``minimize``.  Returns the annotated names."""
    from paddle_tpu_torch.parallel.zero import collect_optimizer_state

    nshard = plan.axis_size(axis)
    names = set()
    if optimizer_state:
        names |= collect_optimizer_state(program)
    if params:
        names |= {v.name for v in program.all_parameters()}
    gb = program.global_block()
    param_names = sorted((v.name for v in program.all_parameters()),
                         key=len, reverse=True)
    annotated = []
    for name in sorted(names):
        var = gb.vars.get(name)
        if var is None or var.shape is None:
            continue
        size = 1
        for d in var.shape:
            size *= max(int(d), 1)
        if not var.shape or size < min_size:
            continue
        if var.sharding is None:
            for pn in param_names:
                if name != pn and name.startswith(pn + "_"):
                    pv = gb.vars.get(pn)
                    if pv is not None and pv.sharding is not None \
                            and pv.shape == var.shape:
                        var.set_sharding(pv.sharding)
                    break
        spec = list(var.sharding) if var.sharding else \
            [None] * len(var.shape)
        while len(spec) < len(var.shape):
            spec.append(None)
        used = {a for e in spec for a in _entry_axes(e)}
        if axis in used:
            # seeded from an annotated parameter: an axis maps to one dim
            annotated.append(name)
            continue
        for i, (dim, entry) in enumerate(zip(var.shape, spec)):
            if entry is None and int(dim) % nshard == 0:
                spec[i] = axis
                var.set_sharding(tuple(spec))
                annotated.append(name)
                break
    return annotated


# the transformer models' param-name grammar (models/transformer.py
# _w/_b under a param_prefix): column-parallel weights split the output
# dim (each tp rank computes its heads / its part of the ffn hidden),
# row-parallel ones the input dim (their products are partial sums)
_TP_COL_SUFFIXES = ("_q.w", "_k.w", "_v.w", "_fc1.w")
_TP_ROW_SUFFIXES = ("_out.w", "_fc2.w")
_TP_COL_BIAS_SUFFIXES = ("_fc1.b",)


def annotate_tp_transformer(program, plan, axis="tp"):
    """The Megatron splits of the transformer layers as tp specs, keyed on
    the names the models give under a ``param_prefix`` (q/k/v/fc1 column,
    out/fc2 row, the fc1 bias with its column).  A model built without a
    prefix gets none.  Returns {"column": [...], "row": [...]}."""
    nshard = plan.axis_size(axis)
    out = {"column": [], "row": []}
    if nshard <= 1:
        return out
    for var in program.global_block().vars.values():
        if not (var.persistable and var.trainable) or var.shape is None:
            continue
        name, shape = var.name, var.shape
        if len(shape) == 2:
            if name.endswith(_TP_COL_SUFFIXES) and \
                    int(shape[1]) % nshard == 0:
                var.set_sharding((None, axis))
                out["column"].append(name)
            elif name.endswith(_TP_ROW_SUFFIXES) and \
                    int(shape[0]) % nshard == 0:
                var.set_sharding((axis, None))
                out["row"].append(name)
        elif len(shape) == 1:
            if name.endswith(_TP_COL_BIAS_SUFFIXES) and \
                    int(shape[0]) % nshard == 0:
                var.set_sharding((axis,))
                out["column"].append(name)
    return out


def carve_slices(devices, slice_size):
    """A flat device list in consecutive ``slice_size`` groups, one a
    replica; the leftover devices stay unused.  Raises when not even one
    slice fits."""
    devices = list(devices)
    slice_size = int(slice_size)
    if slice_size < 1:
        raise ValueError(f"slice_size {slice_size} < 1")
    n = len(devices) // slice_size
    if n < 1:
        raise ValueError(
            f"{len(devices)} devices cannot hold one slice of "
            f"{slice_size} (size the MeshPlan to the fleet)")
    return [devices[i * slice_size:(i + 1) * slice_size]
            for i in range(n)]


# ops whose output keeps its input's feature split (the chain guard looks
# through them); any other consumer of a split activation is a gather
# point and de-annotates its producer
_TP_INFER_PASSTHROUGH = ("relu", "tanh", "sigmoid", "elementwise_add",
                         "fused_elemwise_activation", "scale",
                         "dropout")
_TP_INFER_MATMUL = ("mul", "matmul", "fc")


def _infer_fc_nodes(block):
    """(op, weight var, bias var or None, out name) of each fc-shaped op:
    the raw mul (+ elementwise_add bias) and the fused ``fc``."""
    nodes = []
    for i, op in enumerate(block.ops):
        if op.type in ("mul", "matmul"):
            wname = op.inputs.get("Y", [None])[0]
        elif op.type == "fc":
            wname = op.inputs.get("W", [None])[0]
        else:
            continue
        if wname is None:
            continue
        w = block.vars.get(wname)
        if w is None or not w.persistable or w.shape is None or \
                len(w.shape) != 2:
            continue
        out = op.outputs["Out"][0]
        bias = None
        if op.type == "fc":
            bnames = op.inputs.get("Bias", [])
            bias = block.vars.get(bnames[0]) if bnames else None
        else:
            for later in block.ops[i + 1:]:
                if later.type == "elementwise_add" and \
                        later.inputs.get("X", [None])[0] == out:
                    cand = block.vars.get(
                        later.inputs.get("Y", [None])[0])
                    if cand is not None and cand.persistable and \
                            cand.shape is not None and \
                            len(cand.shape) == 1 and \
                            int(cand.shape[0]) == int(w.shape[1]):
                        bias = cand
                    break
        nodes.append((op, w, bias, out))
    return nodes


def annotate_tp_inference(program, plan, axis="tp"):
    """Column-parallel tp specs on an inference program's fc layers: each
    fc-shaped weight whose output dim divides the tp axis takes (None,
    axis), its bias (axis,).  Column only: every contraction stays
    full-width, so the outputs are bitwise the unsharded ones.  That needs
    the whole chain downstream to hold, so an annotated weight whose
    output reaches an unannotated matmul or any consumer but a
    pass-through is de-annotated, to a fixpoint.  Returns the annotated
    weight and bias names."""
    nshard = plan.axis_size(axis)
    if nshard <= 1:
        return []
    block = program.global_block()
    nodes = _infer_fc_nodes(block)
    sharded = {}
    for op, w, bias, out in nodes:
        if int(w.shape[1]) % nshard == 0 and \
                (bias is None or int(bias.shape[0]) % nshard == 0):
            sharded[w.name] = (w, bias, out)
    consumers = {}
    for op in block.ops:
        for names in op.inputs.values():
            for n in names:
                consumers.setdefault(n, []).append(op)

    def chain_ok(out_name, seen):
        """Whether every consumer of a split activation is a split matmul
        or a pass-through whose own chain holds."""
        if out_name in seen:
            return True
        seen.add(out_name)
        for op in consumers.get(out_name, ()):
            if op.type in _TP_INFER_MATMUL:
                wkey = "W" if op.type == "fc" else "Y"
                if op.inputs.get(wkey, [None])[0] not in sharded:
                    return False
            elif op.type in _TP_INFER_PASSTHROUGH:
                for onames in op.outputs.values():
                    for on in onames:
                        if not chain_ok(on, seen):
                            return False
            else:
                return False
        return True

    changed = True
    while changed:
        changed = False
        for wn in list(sharded):
            if not chain_ok(sharded[wn][2], set()):
                del sharded[wn]
                changed = True
    annotated = []
    for wn, (w, bias, _) in sorted(sharded.items()):
        w.set_sharding((None, axis))
        annotated.append(wn)
        if bias is not None:
            bias.set_sharding((axis,))
            annotated.append(bias.name)
    from paddle_tpu_torch.analysis.passes import verify_enabled

    if verify_enabled():
        from paddle_tpu_torch.analysis.shape_check import check_sharding

        check_sharding(program, plan, label="annotate_tp_inference")
    return annotated


def tag_attention_ops(program, plan, batch_axis=None, head_axis=None):
    """``gspmd_batch_axis``/``gspmd_head_axis`` on every flash_attention
    op and its grad (which recomputes the forward under its own attrs):
    the layout engine runs the kernel on each rank's rows and heads where
    q, k and v are split so, and gathers them otherwise.  Returns the
    number of ops tagged."""
    batch_axis = plan.data_axis if batch_axis is None else batch_axis
    head_axis = ("tp" if "tp" in plan.axes else None) \
        if head_axis is None else head_axis
    n = 0
    for block in program.blocks:
        for op in block.ops:
            if op.type not in ("flash_attention", "flash_attention_grad"):
                continue
            if batch_axis and plan.axis_size(batch_axis) > 1:
                op.set_attr("gspmd_batch_axis", batch_axis)
            if head_axis and plan.axis_size(head_axis) > 1:
                op.set_attr("gspmd_head_axis", head_axis)
            n += 1
    return n
