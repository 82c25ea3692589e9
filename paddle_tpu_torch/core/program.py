"""Program / Block / OpDesc / VarDesc — the serialized program IR.

Counterpart of ``paddle_tpu/core/program.py``.  The dict format of
``to_dict``/``from_dict`` is the same, attr tags (``__ndarray__``,
``__block__``) and the per-var ``sharding`` field included, so a program
serialized by either package loads in the other.  ``sharding`` is kept
as opaque data here; nothing in this package reads it yet.

Every structured IR edit (``append_op``, ``OpDesc.set_attr``,
``VarDesc.set_sharding``) bumps one process-wide mutation counter, as
in the JAX package (``:46-54``): ``CompiledProgram`` revalidates its
memoised program fingerprint with it.  Edit an existing op's attrs
through ``set_attr``, not the raw dict, for the edit to be seen.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from paddle_tpu_torch.core.registry import TensorSpec, get_op_def, \
    infer_shapes
from paddle_tpu_torch.core.types import VarType, dtype_name

# Op role, mirroring the reference's OpRole
FORWARD = "forward"
BACKWARD = "backward"
OPTIMIZE = "optimize"

# global IR mutation counter: bumped by every append_op / OpDesc.set_attr
# / VarDesc.set_sharding so compiled-program fingerprints
# (compiler._program_fingerprint) can memoize cheaply and revalidate on
# any structured IR edit
_IR_MUTATION = [0]


def ir_mutation_counter() -> int:
    return _IR_MUTATION[0]


def _bump_ir_mutation():
    _IR_MUTATION[0] += 1


class BlockRef:
    """Attribute value referring to a sub-block (reference: AttrType BLOCK)."""

    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx

    def __repr__(self):
        return f"BlockRef({self.idx})"

    def __eq__(self, other):
        return isinstance(other, BlockRef) and other.idx == self.idx


def _normalize_sharding(spec):
    """Canonical annotation form: a tuple over dims whose entries are
    None, a str axis name, or a tuple of str axis names."""
    if spec is None:
        return None
    out = []
    for entry in spec:
        if entry is None or isinstance(entry, str):
            out.append(entry)
        elif isinstance(entry, (list, tuple)):
            if not all(isinstance(a, str) for a in entry):
                raise ValueError(
                    f"sharding entry {entry!r}: axis names must be str")
            out.append(tuple(entry))
        else:
            raise ValueError(
                f"sharding entry {entry!r}: expected None, an axis "
                "name, or a tuple of axis names")
    return tuple(out)


class VarDesc:
    """A named variable in a block; doubles as the front-end handle."""

    def __init__(
        self,
        block: "Block",
        name: str,
        shape=None,
        dtype="float32",
        type: VarType = VarType.DENSE_TENSOR,
        persistable: bool = False,
        stop_gradient: bool = False,
        trainable: bool = False,
        is_data: bool = False,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_name(dtype) if dtype is not None else None
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.trainable = trainable
        self.is_data = is_data
        self.sharding = None

    def __repr__(self):
        return (
            f"Var(name={self.name!r}, shape={self.shape}, dtype={self.dtype},"
            f" type={self.type.name}{', persistable' if self.persistable else ''})"
        )

    def set_sharding(self, spec):
        """Annotate this var with a PartitionSpec-like tuple (one entry
        per dim: None | axis name | tuple of axis names), or None to
        clear.  Goes through the IR mutation counter, so an annotation
        edit after a compile changes the program's fingerprint as an op
        edit does."""
        self.sharding = _normalize_sharding(spec)
        _bump_ir_mutation()
        return self

    @property
    def ndim(self):
        return None if self.shape is None else len(self.shape)

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "type": self.type.name,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "trainable": self.trainable,
            "is_data": self.is_data,
            "sharding": [list(e) if isinstance(e, tuple) else e
                         for e in self.sharding]
            if self.sharding else None,
        }

    @staticmethod
    def from_dict(block, d):
        v = VarDesc(
            block,
            d["name"],
            shape=d["shape"],
            dtype=d["dtype"],
            type=VarType[d["type"]],
            persistable=d["persistable"],
            stop_gradient=d["stop_gradient"],
            trainable=d.get("trainable", False),
            is_data=d.get("is_data", False),
        )
        if d.get("sharding"):
            v.sharding = _normalize_sharding(d["sharding"])
        return v


class OpDesc:
    """One operation: type + named input/output var lists + attrs.

    inputs/outputs: {slot: [var_name, ...]} — always lists."""

    def __init__(self, type: str, inputs=None, outputs=None, attrs=None,
                 op_role: str = FORWARD, stage=None):
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.op_role = op_role
        # pipeline stage annotation, carried through serialization
        self.stage = stage

    def set_attr(self, name, value):
        """In-place attr edit visible to compiled-program caching (a raw
        ``op.attrs[k] = v`` write is not: see
        ``compiler._program_fingerprint``)."""
        self.attrs[name] = value
        _bump_ir_mutation()

    def input_names(self):
        out = []
        for names in self.inputs.values():
            out.extend(names)
        return out

    def output_names(self):
        out = []
        for names in self.outputs.values():
            out.extend(names)
        return out

    def __repr__(self):
        return f"Op({self.type}, in={self.inputs}, out={self.outputs})"

    def to_dict(self):
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, BlockRef):
                attrs[k] = {"__block__": v.idx}
            elif isinstance(v, np.ndarray):
                attrs[k] = {
                    "__ndarray__": v.tolist(),
                    "dtype": str(v.dtype),
                }
            elif isinstance(v, (np.integer,)):
                attrs[k] = int(v)
            elif isinstance(v, (np.floating,)):
                attrs[k] = float(v)
            else:
                attrs[k] = v
        out = {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": attrs,
            "op_role": self.op_role,
        }
        if self.stage is not None:
            out["stage"] = self.stage
        return out

    @staticmethod
    def from_dict(d):
        attrs = {}
        for k, v in d["attrs"].items():
            if isinstance(v, dict) and "__block__" in v:
                attrs[k] = BlockRef(v["__block__"])
            elif isinstance(v, dict) and "__ndarray__" in v:
                attrs[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
            else:
                attrs[k] = v
        return OpDesc(
            d["type"], d["inputs"], d["outputs"], attrs,
            d.get("op_role", FORWARD), d.get("stage"),
        )


class Block:
    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: dict = {}
        self.ops: list = []

    @property
    def parent(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # -- variables ---------------------------------------------------------------
    def create_var(self, name=None, **kwargs) -> VarDesc:
        from paddle_tpu_torch import unique_name

        if name is None:
            name = unique_name.generate("_generated_var")
        if name in self.vars:
            return self.vars[name]
        v = VarDesc(self, name, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype, **kwargs) -> VarDesc:
        v = self.create_var(
            name, shape=shape, dtype=dtype, persistable=True, trainable=True,
            **kwargs,
        )
        v.trainable = True
        v.persistable = True
        return v

    def var(self, name) -> VarDesc:
        """Find in this block or its ancestors."""
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        raise KeyError(f"variable '{name}' not found in block {self.idx}")

    def has_var(self, name) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    # -- ops ---------------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  op_role=FORWARD, infer_shape=True) -> OpDesc:
        """Validates against the registry and infers output shapes and
        dtypes (reference: compile-time InferShape)."""
        inputs = {
            k: ([v] if isinstance(v, (VarDesc, str)) else list(v))
            for k, v in (inputs or {}).items()
            if v is not None
        }
        outputs = {
            k: ([v] if isinstance(v, (VarDesc, str)) else list(v))
            for k, v in (outputs or {}).items()
            if v is not None
        }
        in_names = {
            k: [v.name if isinstance(v, VarDesc) else v for v in vs]
            for k, vs in inputs.items()
        }
        out_names = {
            k: [v.name if isinstance(v, VarDesc) else v for v in vs]
            for k, vs in outputs.items()
        }
        op_def = get_op_def(type)
        attrs = op_def.canonical_attrs(attrs or {})
        op = OpDesc(type, in_names, out_names, attrs, op_role)
        self.ops.append(op)
        _bump_ir_mutation()
        if infer_shape and not op_def.host_only:
            self._infer_shape(op, op_def)
        return op

    def _infer_shape(self, op: OpDesc, op_def):
        ins_specs = {}
        for slot, names in op.inputs.items():
            specs = []
            for n in names:
                try:
                    v = self.var(n)
                except KeyError:
                    return
                if v.shape is None or v.dtype is None:
                    return
                specs.append(TensorSpec(tuple(v.shape), v.dtype))
            if slot in op_def.duplicable:
                ins_specs[slot] = specs
            elif specs:
                ins_specs[slot] = specs[0]
        out = infer_shapes(op_def, ins_specs, op.attrs,
                           strict=(self.idx == 0), var_names=op.inputs)
        if out is None:
            return
        for slot, names in op.outputs.items():
            if slot not in out:
                continue
            specs = out[slot]
            if not isinstance(specs, list):
                specs = [specs]
            for n, spec in zip(names, specs):
                try:
                    v = self.var(n)
                except KeyError:
                    continue
                if v.shape is None:
                    v.shape = tuple(spec.shape)
                if v.dtype is None:
                    v.dtype = spec.dtype

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """Reference: python/paddle/fluid/framework.py Program."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self):
        return [v for v in self.list_vars()
                if v.trainable and v.persistable]

    def persistables(self):
        return [v for v in self.list_vars() if v.persistable]

    def clone(self, for_test: bool = False) -> "Program":
        """Deep structural copy.  for_test=True drops backward/optimize
        ops and switches ``is_test`` attrs on."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for v in b.vars.values():
                nv = VarDesc.from_dict(nb, v.to_dict())
                nv.sharding = v.sharding
                nb.vars[v.name] = nv
            for op in b.ops:
                if for_test and op.op_role in (BACKWARD, OPTIMIZE):
                    continue
                nop = OpDesc.from_dict(op.to_dict())
                if for_test and "is_test" in nop.attrs:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        p.current_block_idx = 0
        return p

    # -- serialization ------------------------------------------------------------
    def to_dict(self):
        return {
            "version": 1,
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_dict()).encode("utf-8")

    @staticmethod
    def from_dict(d) -> "Program":
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                b.vars[vd["name"]] = VarDesc.from_dict(b, vd)
            for od in bd["ops"]:
                b.ops.append(OpDesc.from_dict(od))
            p.blocks.append(b)
        if not p.blocks:
            p.blocks = [Block(p, 0)]
        return p

    @staticmethod
    def parse_from_bytes(data: bytes) -> "Program":
        return Program.from_dict(json.loads(data.decode("utf-8")))

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"-- block {b.idx} (parent {b.parent_idx}) --")
            for v in b.vars.values():
                lines.append(f"  {v!r}")
            for op in b.ops:
                lines.append(f"  {op!r}")
        return "\n".join(lines)
