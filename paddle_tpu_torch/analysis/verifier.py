"""Structural Program/Block/Op verifier.

Counterpart of ``paddle_tpu/analysis/verifier.py``, over the port's
``core/registry.py`` and ``core/program.py``, with the same rules, rule
names and messages, so the two packages name a fault alike.

The IR invariants every transpiler pass must preserve, checked in one
O(ops) walk with typed diagnostics that name block / op-index / var:

  * ``unknown-op``        — every op type resolves in the registry
                            (incl. synthesized ``<fwd>_grad`` defs).
  * ``unregistered-attr`` — op attrs are exactly the registered attr
                            schema: no attr outside the op def, no
                            REQUIRED attr missing (a rewrite that
                            invents an attr the kernel never reads is
                            caught here, not at trace time).
  * ``unknown-slot``      — input/output slot names belong to the op
                            def (grad ops validate against their
                            synthesized grad def).
  * ``undefined-input``   — block-0 op inputs resolve to a VarDesc via
                            the parent-block chain (host-only ops are
                            exempt: they read runtime scope vars; sub-
                            block ops likewise — RPC-filled section
                            vars live only in the scope).
  * ``use-before-def``    — block-0 ordering: a non-persistable,
                            non-data var whose only producers come
                            LATER in the block cannot be consumed
                            (in-place writes to persistables are the
                            legal exception).
  * ``duplicate-output``  — one op listing the same var twice in one
                            output slot (two writes, undefined order).
  * ``misparented-var``   — every ``block.vars[name]`` has
                            ``v.name == name`` and ``v.block is
                            block`` (clone/from_dict bookkeeping).
  * ``grad-pairing``      — ``<X>_grad`` ops: X registered and
                            differentiable, and the op carries the
                            backward role.
  * ``feed-missing`` / ``fetch-missing`` — caller-declared feed/fetch
                            targets exist in the program.
  * ``roundtrip``         — opt-in: to_dict/from_dict and clone()
                            preserve the program fingerprint
                            (serialization loses nothing the jit
                            cache keys on).

``verify`` returns the diagnostic list (and raises ``VerifierError``
on any error-severity diagnostic unless ``raise_=False``).  Warnings
(e.g. ``orphan-var``) never raise: transpilers legally strand the
VarDescs of fused-away intermediates.
"""

from __future__ import annotations

from paddle_tpu_torch.core.program import BlockRef
from paddle_tpu_torch.core.registry import (REQUIRED, get_op_def,
                                           has_op_def)

_ERROR = "error"
_WARNING = "warning"

# op roles a grad op may legally carry (backward.py always stamps
# BACKWARD; clones/pipeline cuts preserve it)
_GRAD_ROLES = ("backward",)


class Diagnostic:
    """One typed verifier finding, locating block / op-index / var."""

    __slots__ = ("rule", "severity", "block_idx", "op_idx", "op_type",
                 "var", "message")

    def __init__(self, rule, message, severity=_ERROR, block_idx=None,
                 op_idx=None, op_type=None, var=None):
        self.rule = rule
        self.severity = severity
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.var = var
        self.message = message

    def __repr__(self):
        return f"Diagnostic({self!s})"

    def __str__(self):
        loc = []
        if self.block_idx is not None:
            loc.append(f"block {self.block_idx}")
        if self.op_idx is not None:
            loc.append(f"op {self.op_idx}")
        if self.op_type is not None:
            loc.append(f"({self.op_type})")
        if self.var is not None:
            loc.append(f"var '{self.var}'")
        where = " ".join(loc)
        return f"[{self.rule}] {where}: {self.message}" if where else \
            f"[{self.rule}] {self.message}"


class VerifierError(RuntimeError):
    """Raised by ``verify`` when any error-severity diagnostic fires.
    ``.diagnostics`` holds the full typed list (warnings included)."""

    code = "ir_verify"

    def __init__(self, diagnostics, label=""):
        self.diagnostics = list(diagnostics)
        self.label = label
        errors = [d for d in self.diagnostics if d.severity == _ERROR]
        head = f"IR verification failed{f' ({label})' if label else ''}: " \
               f"{len(errors)} error(s)"
        super().__init__(
            "\n  ".join([head] + [str(d) for d in self.diagnostics]))


def _visible_in_ancestors(block, name):
    b = block.parent
    while b is not None:
        if name in b.vars:
            return True
        b = b.parent
    return False


def _check_block(block, diags):
    bidx = block.idx
    # -- var table bookkeeping -------------------------------------------
    for name, v in block.vars.items():
        if v.name != name:
            diags.append(Diagnostic(
                "misparented-var",
                f"vars[{name!r}] holds a VarDesc named {v.name!r}",
                block_idx=bidx, var=name))
        if v.block is not block:
            diags.append(Diagnostic(
                "misparented-var",
                "VarDesc.block does not point at its containing block",
                block_idx=bidx, var=name))

    # first producer index per var name (this block only)
    first_def = {}
    for i, op in enumerate(block.ops):
        for n in op.output_names():
            first_def.setdefault(n, i)

    referenced = set()
    for i, op in enumerate(block.ops):
        known = has_op_def(op.type)
        if not known:
            diags.append(Diagnostic(
                "unknown-op",
                f"op type {op.type!r} is not registered",
                block_idx=bidx, op_idx=i, op_type=op.type))
        op_def = None
        if known:
            try:
                op_def = get_op_def(op.type)
            except KeyError as e:
                # X_grad whose forward X is registered but not
                # differentiable: the synthesized grad def refuses
                diags.append(Diagnostic(
                    "grad-pairing", str(e),
                    block_idx=bidx, op_idx=i, op_type=op.type))

        # -- attr schema -------------------------------------------------
        if op_def is not None:
            extra = set(op.attrs) - set(op_def.attrs)
            if extra:
                diags.append(Diagnostic(
                    "unregistered-attr",
                    f"attrs {sorted(extra)} are not in the registered "
                    f"schema {sorted(op_def.attrs)}",
                    block_idx=bidx, op_idx=i, op_type=op.type))
            for aname, default in op_def.attrs.items():
                if default is REQUIRED and aname not in op.attrs:
                    diags.append(Diagnostic(
                        "unregistered-attr",
                        f"required attr {aname!r} missing",
                        block_idx=bidx, op_idx=i, op_type=op.type))
            # -- epilogue stage list ------------------------------------
            # ops carrying a fused stage list (conv2d_epilogue,
            # conv2d_bn_train, fc_epilogue, conv2d_int8, ...) declare
            # an "epilogue" attr; a non-empty value must parse against
            # the stage grammar (ops/epilogue.py) — transpilers build
            # it via spec_attr so this only fires on hand-edited IR
            ep = op.attrs.get("epilogue", "")
            if ep:
                from paddle_tpu_torch.ops.epilogue import EpilogueSpec

                try:
                    EpilogueSpec.from_attr(ep).validate()
                except ValueError as e:
                    diags.append(Diagnostic(
                        "epilogue-spec",
                        f"attr 'epilogue' {ep!r} is not a valid stage "
                        f"list: {e}",
                        block_idx=bidx, op_idx=i, op_type=op.type))
            # -- slot validity ------------------------------------------
            for slot in op.inputs:
                if slot not in op_def.inputs:
                    diags.append(Diagnostic(
                        "unknown-slot",
                        f"input slot {slot!r} is not in the op def "
                        f"{tuple(op_def.inputs)}",
                        block_idx=bidx, op_idx=i, op_type=op.type))
            for slot in op.outputs:
                if slot not in op_def.outputs:
                    diags.append(Diagnostic(
                        "unknown-slot",
                        f"output slot {slot!r} is not in the op def "
                        f"{tuple(op_def.outputs)}",
                        block_idx=bidx, op_idx=i, op_type=op.type))

        # -- sub-block references ---------------------------------------
        for aname, aval in op.attrs.items():
            if isinstance(aval, BlockRef) and not (
                    0 <= aval.idx < len(block.program.blocks)):
                diags.append(Diagnostic(
                    "block-ref",
                    f"attr {aname!r} references block {aval.idx} but "
                    f"the program has {len(block.program.blocks)} "
                    "block(s)",
                    block_idx=bidx, op_idx=i, op_type=op.type))

        # -- grad pairing ------------------------------------------------
        if op.type.endswith("_grad"):
            if op.op_role not in _GRAD_ROLES:
                diags.append(Diagnostic(
                    "grad-pairing",
                    f"grad op carries op_role {op.op_role!r} "
                    f"(expected one of {_GRAD_ROLES})",
                    severity=_WARNING,
                    block_idx=bidx, op_idx=i, op_type=op.type))

        # -- dataflow ----------------------------------------------------
        produced_here = set(op.output_names())
        for n in op.input_names():
            referenced.add(n)
            in_block = n in block.vars
            if not in_block and not _visible_in_ancestors(block, n):
                host_ok = op_def is not None and op_def.host_only
                if bidx == 0 and not host_ok:
                    diags.append(Diagnostic(
                        "undefined-input",
                        "input var is declared in no block "
                        "(dangling name)",
                        block_idx=bidx, op_idx=i, op_type=op.type,
                        var=n))
                continue
            if bidx != 0:
                # sub-blocks run under control-flow/section semantics:
                # ordering is the runtime's business, existence was
                # checked above
                continue
            v = block.vars.get(n)
            if v is None or v.persistable or v.is_data:
                continue
            fd = first_def.get(n)
            if fd is not None and fd > i and n not in produced_here:
                diags.append(Diagnostic(
                    "use-before-def",
                    f"first producer is op {fd}, after this use",
                    block_idx=bidx, op_idx=i, op_type=op.type, var=n))
        for slot, names in op.outputs.items():
            referenced.update(names)
            seen = set()
            for n in names:
                if n in seen:
                    diags.append(Diagnostic(
                        "duplicate-output",
                        f"var listed twice in output slot {slot!r}",
                        block_idx=bidx, op_idx=i, op_type=op.type,
                        var=n))
                seen.add(n)

    # -- orphan vars (warning only: fuse passes legally strand the
    # VarDescs of erased intermediates) --------------------------------
    for name, v in block.vars.items():
        if name in referenced or v.persistable or v.is_data:
            continue
        diags.append(Diagnostic(
            "orphan-var",
            "var is referenced by no op in its block",
            severity=_WARNING, block_idx=bidx, var=name))


def verify(program, feeds=None, fetches=None, roundtrip=False,
           raise_=True, label=""):
    """Run every structural rule over ``program``.

    feeds/fetches: optional iterables of var names (or VarDescs) that
    must exist in the program — the executor/predictor feed+fetch
    contract, checked statically.  roundtrip=True additionally asserts
    to_dict/from_dict and clone() fingerprint stability (O(program)
    serialization — gate/test use, not per-pass use).

    Returns the list of Diagnostics; raises VerifierError iff any has
    error severity and ``raise_`` (warnings never raise).
    """
    diags = []
    for block in program.blocks:
        if block.idx != program.blocks.index(block):
            diags.append(Diagnostic(
                "misparented-var",
                f"block list position {program.blocks.index(block)} "
                f"holds block.idx {block.idx}", block_idx=block.idx))
        if block.parent_idx >= 0 and not (
                0 <= block.parent_idx < len(program.blocks)):
            diags.append(Diagnostic(
                "misparented-var",
                f"parent_idx {block.parent_idx} out of range",
                block_idx=block.idx))
        _check_block(block, diags)

    def _name(t):
        return t if isinstance(t, str) else t.name

    gb = program.global_block()
    for t in (feeds or ()):
        n = _name(t)
        if not gb.has_var(n):
            diags.append(Diagnostic(
                "feed-missing", "declared feed target does not exist",
                block_idx=0, var=n))
    for t in (fetches or ()):
        n = _name(t)
        if not gb.has_var(n):
            diags.append(Diagnostic(
                "fetch-missing",
                "declared fetch target does not exist",
                block_idx=0, var=n))

    if roundtrip:
        diags.extend(verify_roundtrip(program, raise_=False))

    if raise_ and any(d.severity == _ERROR for d in diags):
        raise VerifierError(diags, label=label)
    return diags


def verify_roundtrip(program, raise_=True, label=""):
    """to_dict/from_dict and clone() must preserve the program
    fingerprint — the jit-cache / registry-dedupe key.  A pass whose
    rewrite survives in memory but not through serialization corrupts
    every consumer of the saved form (model registry, elastic resume,
    pserver programs on the wire)."""
    from paddle_tpu_torch.core.compiler import program_fingerprint
    from paddle_tpu_torch.core.program import Program

    diags = []
    try:
        fp = program_fingerprint(program)
    except TypeError as e:
        # an attr the fingerprint can't hash can't serialize either
        diags.append(Diagnostic(
            "roundtrip",
            f"program does not fingerprint: TypeError: {e}"))
        if raise_:
            raise VerifierError(diags, label=label)
        return diags
    try:
        restored = Program.parse_from_bytes(program.to_bytes())
    except (TypeError, ValueError) as e:
        diags.append(Diagnostic(
            "roundtrip",
            f"program does not serialize: {type(e).__name__}: {e}"))
        restored = None
    if restored is not None and program_fingerprint(restored) != fp:
        diags.append(Diagnostic(
            "roundtrip",
            "to_bytes/parse_from_bytes changed the program "
            f"fingerprint ({fp} -> {program_fingerprint(restored)})"))
    cloned = program.clone()
    if program_fingerprint(cloned) != fp:
        diags.append(Diagnostic(
            "roundtrip",
            "clone() changed the program fingerprint "
            f"({fp} -> {program_fingerprint(cloned)})"))
    if raise_ and any(d.severity == _ERROR for d in diags):
        raise VerifierError(diags, label=label)
    return diags
