"""CompiledProgram: a block resolved once into a plan and, on the card,
captured into CUDA graphs and replayed.

Counterpart of ``paddle_tpu/core/compiler.py``.  The JAX package traces
the whole block into one jitted XLA function, donates the persistable
state so updates alias buffers (``:682-733``), and keys a cache on feed
shapes, fetch names and a structural program fingerprint (``:97-185``,
``:841-878``).  Here:

- The plan (``_build_fn``).  Each op of the global block is resolved
  once (``executor.ResolvedOp``: its ``OpDef``, input and output names,
  optional and duplicable slots, the interpreter's own contract).  Ops in
  ``_SKIP_IN_TRACE`` are skipped and host-only ops in
  ``_HOST_SKIP_SILENT`` dropped, as the JAX package does; the outputs of
  a host-only op that only an executor handler runs are poisoned
  (``_TraceEnv``: reading one raises a clear error).  Any other host-only
  op splits the plan: it runs eagerly between two device segments, where
  the JAX package uses ``pure_callback``.  Ops with no inputs
  (``fill_constant``, ``assign_value``, the random fills, which draw on
  the host) run once when the plan is built and their values are reused
  every step, as the JAX trace bakes them into the program as constants.
  Control flow (``_CONTROL_FLOW``) is not ported and raises at build time.
- Persistables at fixed addresses.  The scope's tensor of each persistable
  becomes its buffer; a value the block writes to a persistable (an
  optimizer's ``ParamOut`` is a new tensor) is copied back into that
  buffer at the end of its segment, the counterpart of ``donate_argnums``.
  A tensor the caller sets into the scope in a buffer's place is copied
  into the buffer at the next run; one of another shape or dtype rebinds
  every buffer and rebuilds every graph.
- On a CUDA place, the first run of a key (feed shapes and dtypes, fetch
  names, program fingerprint) runs the plan eagerly on a side stream:
  its results are real (the step updates the state and is returned), and
  it builds each hand kernel on first use and initialises cuBLAS and
  cuDNN.  Then each segment is captured into a CUDA graph on that
  stream, with the feeds in fixed buffers that later runs copy into
  before they replay.  All graphs of one CompiledProgram share one
  memory pool, freed with it.  An op that synchronises (``.item()``, a
  copy to pageable memory, a device synchronise) is an error inside a
  capture: the capture fails and ``run`` raises, caching nothing.  A
  capture or replay failure raises: nothing falls back to the
  interpreter (a capture that fails after its warm-up leaves the
  warm-up's step applied).  Fetches are copied out (to page-locked host
  memory, or cloned with ``return_numpy=False``), so the caller never
  holds memory that the next replay overwrites.
- On ``CPUPlace`` the same plan runs eagerly every step.
- More than one caller on a card.  A capture runs in CUDA's thread-local
  mode (``capture_error_mode="thread_local"``) on its instance's side
  stream, a non-blocking stream that PyTorch made: only the capturing
  thread is held to the capture's rules, and PyTorch's caching allocator
  sends only that stream's allocations to the graph's pool.  Other
  threads may launch graphs, allocate, copy to pinned memory and
  synchronise their own streams while it runs.  So a run of a cached key
  (its feed copies, its replay, its fetch) never waits for another
  instance's warm-up or capture, and they never wait for it.  Warm-ups
  and captures on one device still take one lock (``_device_lock``), one
  at a time: the kernel wrappers count their launches in process-wide
  counters, and a capture records their deltas.  Runs of one instance
  stay in order under its own lock.

The kernel wrappers count their launches on the host, so their counts
tick while the plan runs eagerly or captures, never on a replay: each
capture records the counts' deltas (``ops.kernel_launches``), and
``replayed_launches`` multiplies them by the replays.

Data parallelism (``with_data_parallel``, ``with_sharding_rules``): one
process a device, each rank feeding its local shard of the batch.  The
plan reduces the gradients between the backward ops and the optimizer's,
and ZeRO updates sharded parameters in rows (``core/data_parallel.py``);
the program itself is left as it is.  Every step first checks that the
ranks' feeds have the same batch size (else the JAX package's
``ValueError`` naming "divide"); batch-reducing ops take the global
batch's statistics (``parallel.env.data_parallel``); the ``loss_name``
fetch is the global mean, a batch-major fetch is gathered in rank order,
persistables and reduced gradients come back as they are, and any other
fetch raises ``DataParallelFetchError``.  Collectives run in the plan's
order on every rank.  On ``gloo`` a collective, and an op that issues
one (``ops/collective.py``, the batch statistics' ops), is a host step
between two CUDA graphs; on ``nccl`` it is captured in the graph.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

from paddle_tpu_torch.core import data_parallel as _dp
from paddle_tpu_torch.core.executor import (_SPECIAL_OPS, ResolvedOp,
                                            feed_tensor, fetch_name)
from paddle_tpu_torch.core.program import BlockRef, Program
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.core.types import to_numpy
from paddle_tpu_torch.observability import device_trace as _obs_device
from paddle_tpu_torch.observability import collector as _obs_collector
from paddle_tpu_torch.observability import flight_recorder as _obs_flight
from paddle_tpu_torch.observability import metrics as _obs_metrics
from paddle_tpu_torch.observability import tracing as _obs_trace
from paddle_tpu_torch.parallel import env as _penv

# executor observability: per-step wall time and compile events ride the
# process registry next to the serving instruments
_M_STEP_SECONDS = _obs_metrics.histogram(
    "paddle_tpu_executor_step_seconds",
    "compiled-program step wall time (dispatch, not device-sync)")
_M_COMPILES = _obs_metrics.counter(
    "paddle_tpu_executor_compiles_total",
    "CompiledProgram cache misses (plans built, warmed up and captured)")

# host-only op types silently skipped in the plan (IO/readers run outside
# the compiled step, like the reference's feed/fetch special handling)
_SKIP_IN_TRACE = {"feed", "fetch", "print", "save", "load", "save_combine",
                  "load_combine", "c_comm_init", "c_gen_nccl_id"}

_HOST_SKIP_SILENT = {
    # side-effect / bootstrap ops with no data outputs the plan could
    # consume (or whose outputs arrive via state/feeds instead).
    # NOTE: feed/fetch/print/save/load-style ops never reach this set —
    # _SKIP_IN_TRACE short-circuits them first.
    "checkpoint_notify", "delete_var", "send", "recv", "send_barrier",
    "fetch_barrier", "listen_and_serv", "create_py_reader", "read",
    "py_reader", "fake_init", "ps_sync_init", "get_places",
}

# ops that issue a collective in a data-parallel step (the batch
# statistics): a host step on gloo, as ops/collective.py's are
_BATCH_STAT_OPS = frozenset(("batch_norm", "batch_norm_grad",
                             "conv2d_bn_train", "conv2d_bn_train_grad"))

# the JAX package lowers these to lax control flow; the port has none yet
_CONTROL_FLOW = {"while", "conditional_block", "conditional_block_infer",
                 "cond", "static_rnn", "static_rnn_grad", "recurrent"}


class _TraceEnv(dict):
    """name -> tensor, plus poisoned names that raise a clear error when
    anything reads them (host-only op outputs that cannot join the
    compiled program)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._poisoned = {}

    def poison(self, name, message):
        self._poisoned[name] = message

    def __setitem__(self, name, value):
        # a later legitimate write (IR freely reuses names) un-poisons
        self._poisoned.pop(name, None)
        super().__setitem__(name, value)

    def update(self, *a, **k):
        for d in a:
            for name in d:
                self._poisoned.pop(name, None)
        for name in k:
            self._poisoned.pop(name, None)
        super().update(*a, **k)

    def poisoned(self, name):
        return self._poisoned.get(name)

    def __getitem__(self, name):
        if name in self._poisoned:
            raise RuntimeError(
                f"compile: '{name}' is unavailable — "
                + self._poisoned[name])
        return super().__getitem__(name)

    def get(self, name, default=None):
        if name in self._poisoned:
            raise RuntimeError(
                f"compile: '{name}' is unavailable — "
                + self._poisoned[name])
        return super().get(name, default)


def _fp_encode(h, v):
    """Streams a typed, length-prefixed encoding of a canonical value
    (``_program_fingerprint``'s ``attr_key``) into the digest ``h``.
    Numbers that compare equal encode alike (bools and integral floats
    as ints), as they hashed alike under ``hash``; a list and a tuple
    encode alike too.  A type whose serialisation is not deterministic
    raises ``TypeError``."""
    import numpy as _np

    if isinstance(v, _np.generic):
        v = v.item()
    if v is None:
        h.update(b"N")
    elif isinstance(v, (bool, int)) or (
            isinstance(v, float) and v.is_integer()):
        h.update(b"i%d;" % int(v))
    elif isinstance(v, float):
        h.update(b"f" + v.hex().encode() + b";")
    elif isinstance(v, str):
        b = v.encode("utf-8", "surrogatepass")
        h.update(b"s%d:" % len(b) + b)
    elif isinstance(v, bytes):
        h.update(b"b%d:" % len(v) + v)
    elif isinstance(v, (list, tuple)):
        h.update(b"L%d:" % len(v))
        for x in v:
            _fp_encode(h, x)
    else:
        raise TypeError(f"program_fingerprint: no deterministic encoding "
                        f"of a {type(v).__name__} value ({v!r})")


def _program_fingerprint(program):
    """Structural content digest of the IR.

    A keyed BLAKE2b digest of a canonical, typed encoding
    (``_fp_encode``) of the program's sharding annotations, var names,
    shapes, dtypes and persistability, and each op's type, stage, slots
    and attrs (an array attr by its dtype, shape and bytes), so one
    program has one fingerprint in every process, whatever
    ``PYTHONHASHSEED`` is.  The full digest is O(total ops), so it is
    memoized per program and revalidated with a cheap token: (total op
    count, hash of the op-object identity tuple, the global IR mutation
    counter bumped by append_op/set_attr/set_sharding).  Transpiler edits
    create/replace OpDesc objects and builder edits go through
    append_op/set_attr, so either changes the token; mutate op.attrs
    through OpDesc.set_attr (not the raw dict) for in-place attr edits to
    be seen."""
    import hashlib

    import numpy as _np

    from paddle_tpu_torch.core.program import ir_mutation_counter

    total = 0
    idh = 0
    for b in program.blocks:
        total += len(b.ops)
        idh = hash((idh,) + tuple(id(op) for op in b.ops))
    token = (total, idh, ir_mutation_counter())
    cached = program.__dict__.get("_fp_cache")
    if cached is not None and cached[0] == token:
        return cached[1]

    def attr_key(v):
        if isinstance(v, BlockRef):
            return ("__block__", v.idx)
        if isinstance(v, _np.ndarray):
            return ("__nd__", v.shape, str(v.dtype), v.tobytes())
        if isinstance(v, (list, tuple)):
            return tuple(attr_key(x) for x in v)
        if isinstance(v, dict):  # e.g. serialized segment ops
            return tuple(sorted((k, attr_key(x)) for k, x in v.items()))
        return v

    def dtype_key(dt):
        try:
            return str(_np.dtype(dt))
        except TypeError:
            return str(dt)

    h = hashlib.blake2b(digest_size=8, person=b"paddle_tpu_fp")
    for b in program.blocks:
        # sharding annotations are part of the program's identity
        for v in b.vars.values():
            if v.sharding is not None:
                _fp_encode(h, ("__sharding__", v.name,
                               attr_key(v.sharding)))
        # declared var shapes/dtypes too: two MLPs differing only in a
        # layer width have identical op lists (the width lives on the
        # VarDescs), and a resized weight must read as another program
        for name in sorted(b.vars):
            v = b.vars[name]
            _fp_encode(h, (
                "__var__", name,
                None if v.shape is None
                else tuple(int(d) for d in v.shape),
                None if v.dtype is None else dtype_key(v.dtype),
                bool(v.persistable)))
        for op in b.ops:
            _fp_encode(h, (
                "__op__", op.type, op.stage,
                tuple((s, tuple(n)) for s, n in sorted(op.inputs.items())),
                tuple((s, tuple(n))
                      for s, n in sorted(op.outputs.items())),
                tuple((k, attr_key(v))
                      for k, v in sorted(op.attrs.items())),
            ))
    fp = int.from_bytes(h.digest(), "little", signed=True)
    program._fp_cache = (token, fp)
    return fp


def program_fingerprint(program):
    """Public structural content hash of a program's IR, the value the
    compiled cache keys on (``_program_fingerprint``).  Two programs with
    identical ops/attrs/vars/shardings hash equal; any op, attr, var or
    sharding-annotation edit changes the value."""
    return _program_fingerprint(program)


class _DeviceLock:
    """The compiled path's lock on one device: warm-ups and captures hold
    it one at a time (``capture``); runs of cached keys (``run``) never
    wait for it.  It counts the runs that end while a capture holds it:
    ``captures`` keeps, for each recent capture, its seconds and that
    count."""

    def __init__(self):
        self._capture = threading.Lock()
        self._guard = threading.Lock()
        self._runs = 0
        self.captures = collections.deque(maxlen=4096)

    @contextlib.contextmanager
    def capture(self):
        with self._capture:
            with self._guard:
                runs = self._runs
            t0 = time.perf_counter()
            try:
                yield
            finally:
                with self._guard:
                    self.captures.append((time.perf_counter() - t0,
                                          self._runs - runs))

    @contextlib.contextmanager
    def run(self):
        try:
            yield
        finally:
            with self._guard:
                self._runs += 1


class _NoLock:
    """The lock of a device that needs none (the CPU: each instance's
    own lock orders its runs)."""

    run = capture = staticmethod(contextlib.nullcontext)


_DEVICE_LOCKS = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def _device_lock(device):
    """The lock every ``CompiledProgram`` on ``device`` shares."""
    if device.type != "cuda":
        return _NoLock
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _DEVICE_LOCKS_GUARD:
        return _DEVICE_LOCKS.setdefault(index, _DeviceLock())


def _storage(t):
    return t.untyped_storage().data_ptr()


class _Segment:
    """A run of device ops: ``steps`` are (ResolvedOp, the outputs of an
    op with no inputs computed at build, or None), ``writes_state`` the
    persistables it writes, ``live_after`` the names read after it (by a
    later item, or fetched).  On the card it is captured as ``graph``,
    whose capture added ``launches`` to the kernels' counts."""

    __slots__ = ("steps", "writes_state", "live_after", "graph",
                 "launches")

    def __init__(self):
        self.steps = []
        self.writes_state = []
        self.live_after = ()
        self.graph = None
        self.launches = {}


class _HostOp:
    """A host-only op between two segments.  ``outputs`` are its outputs
    from the eager run ({name: tensor}), or None when they were poisoned
    with ``reason``; on the card a replay calls it on ``ins`` (fixed
    tensors) and copies its outputs into ``buffers``."""

    __slots__ = ("rop", "outputs", "reason", "ins", "buffers")

    def __init__(self, rop):
        self.rop = rop
        self.outputs = None
        self.reason = None
        self.ins = None
        self.buffers = None


class _Entry:
    """One cache key's plan (``items``), the storages of its constant
    values, its feed buffers and fetched tensors on the card, and its
    replays."""

    def __init__(self, items, fetch_names, constants):
        self.items = items
        self.fetch_names = fetch_names
        self.constants = constants
        self.feed_buffers = {}
        self.fetches = None
        self.replays = 0

    @property
    def segments(self):
        return [i for i in self.items if isinstance(i, _Segment)]


class BuildStrategy:
    """Knob container kept for API parity (reference
    details/build_strategy.h); capturing a block is all the port does
    with a build."""

    def __init__(self):
        self.reduce_strategy = "AllReduce"
        self.fuse_all_reduce_ops = True
        self.memory_optimize = True
        self.enable_inplace = True


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1


def _scope_holding(scope, name):
    """The scope of ``scope``'s chain whose own entry ``name`` is."""
    while name not in scope.vars:
        scope = scope.parent
    return scope


class CompiledProgram:
    """reference compiler.py:48."""

    def __init__(self, program_or_graph, build_strategy=None):
        self._program: Program = program_or_graph
        self._cache = {}
        self._lock = threading.Lock()
        # what the cache's entries were built against: the scope, the
        # device and each persistable's fixed buffer there
        self._scope = None
        self._device = None
        self._state = {}
        self._state_storages = set()
        self._pool = None
        self._stream = None
        # data parallelism: the mesh and its data axis, the loss, ZeRO's
        # rule and, once bound, this rank's rows; the fetch rules' cache
        self._mesh = None
        self._data_axis = "dp"
        self._loss_name = None
        self._sharding_fn = None
        self._zero = {}
        self._rules = self._rules_key = None

    # -- parity API -------------------------------------------------------
    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None, mesh=None):
        """Data parallelism over the mesh's data axis ('dp', else its first
        axis): ``mesh``, else the current one, else a 1-D mesh over the
        world, set as current.  One process drives one device: more
        ``places`` than the world's ranks raise, naming the launcher.  On a
        world of one (no process group) the block runs as it is."""
        if loss_name is not None and not isinstance(loss_name, str):
            loss_name = loss_name.name
        if places is not None and len(places) > _penv.world_size():
            raise NotImplementedError(
                f"CompiledProgram.with_data_parallel: {len(places)} places "
                f"for a world of {_penv.world_size()} process(es); the "
                "port drives one device a process: start one a device with "
                f"python -m paddle_tpu_torch.launch --nproc_per_node "
                f"{len(places)}")
        self._loss_name = loss_name
        if mesh is None:
            mesh = _penv.get_mesh() or _penv.make_mesh()
        self._set_mesh(mesh)
        return self

    def _set_mesh(self, mesh):
        self._mesh = _penv.set_mesh(mesh)
        self._data_axis = "dp" if "dp" in mesh.axis_names \
            else mesh.axis_names[0]
        self._cache.clear()
        self._scope = None        # ZeRO's rows rebind with the mesh

    def with_inference_optimize(self, config=None):
        """Nothing differs for inference: the same plan and graphs."""
        return self

    def with_sharding_rules(self, fn, mesh=None):
        """``fn(var_name, shape) -> PartitionSpec or None`` for persistable
        state.  The port runs ZeRO's rules (``parallel.zero``: optimizer
        accumulators sharded on dim 0 over the data axis, stages 1 and 2):
        each rank holds and updates its rows, which ``sharded_state``
        returns; the scope's entry of such an accumulator refuses a read
        (``data_parallel.ShardedVariable``).  A rule that shards a
        parameter (stage 3), or takes another spec, raises here, naming
        the gspmd item."""
        if mesh is not None:
            self._set_mesh(mesh)
        axis = self._data_axis
        if self._mesh is not None and axis not in self._mesh.axis_names:
            axis = self._mesh.axis_names[0]
        _dp.zero_layout(self._program, fn, axis)
        self._sharding_fn = fn
        self._cache.clear()
        self._scope = None
        return self

    def _dp(self):
        """(group, ranks) of the data axis, or None (no mesh, or a world
        of one with no process group)."""
        if self._mesh is None:
            return None
        group = self._mesh.group(self._data_axis)
        if group is None:
            return None
        return group, self._mesh.shape[self._data_axis]

    # -- what a run can read back -----------------------------------------
    def replayed_launches(self) -> dict:
        """{kernel count: launches} that the replays of every cached
        graph made: each capture's deltas of ``ops.kernel_launches`` times
        its entry's replays."""
        total = {}
        for entry in self._cache.values():
            for seg in entry.segments:
                for k, v in seg.launches.items():
                    total[k] = total.get(k, 0) + v * entry.replays
        return total

    def graph_stats(self) -> dict:
        """Entries (one a key), captured graphs and replays so far."""
        entries = list(self._cache.values())
        return {"entries": len(entries),
                "graphs": sum(1 for e in entries for s in e.segments
                              if s.graph is not None),
                "replays": sum(e.replays for e in entries)}

    @property
    def _persistable_names(self):
        return [v.name for v in self._program.persistables()
                if not v.is_data]

    # -- the plan ---------------------------------------------------------
    def _dp_steps(self, ops):
        """A data-parallel step's plan steps (``core/data_parallel.py``):
        ({op index: [steps before it]}, {op index: [steps after it]},
        {optimize op index: {parameter: ZeroRows}})."""
        dp = self._dp()
        if dp is None:
            return {}, {}, {}
        group, size = dp
        first, grads = _dp.step_grads(ops)
        if first is None or not grads:
            return {}, {}, {}
        zero = self._zero
        grad_of = {}
        for op in ops:
            if op.op_role == "optimize" and "Grad" in op.inputs \
                    and "Param" in op.inputs:
                for p, g in zip(op.inputs["Param"], op.inputs["Grad"]):
                    if p in zero:
                        grad_of[g] = p
        before = []
        plain = [g for g in grads if g not in grad_of]
        if plain:
            before.append(_dp.all_reduce_step(plain, group, size))
        sharded = [g for g in grads if g in grad_of]
        if sharded:
            before.append(_dp.reduce_scatter_step(
                sharded, [zero[grad_of[g]] for g in sharded], group, size))
        after, wraps = {}, {}
        if zero:
            last, rows_only = None, set(sharded)
            for i, op in enumerate(ops):
                if op.op_role != "optimize":
                    continue
                read = rows_only.intersection(op.input_names())
                if any(p in zero for p in op.inputs.get("Param", ())):
                    wraps[i] = {p: zero[p] for p in op.inputs["Param"]
                                if p in zero}
                    last = i
                    stray = [g for p, g in zip(op.inputs["Param"],
                                               op.inputs["Grad"])
                             if p in zero and g not in rows_only]
                    if stray:
                        raise NotImplementedError(
                            f"with_sharding_rules: '{op.type}' updates a "
                            f"ZeRO-sharded parameter from {stray}, which "
                            "no backward op writes; only a gradient of "
                            "the backward can be reduce-scattered into "
                            f"rows (waits for {_dp.GSPMD_ITEM})")
                elif op.type == "check_finite_and_unscale" and read:
                    # its flag saw this rank's rows only
                    zero_on_inf = get_op_def(op.type).canonical_attrs(
                        op.attrs)["zero_on_inf"]
                    after.setdefault(i, []).append(_dp.found_inf_step(
                        op.outputs["FoundInfinite"][0], op.outputs["Out"],
                        zero_on_inf, group, size))
                elif read:
                    raise NotImplementedError(
                        f"with_sharding_rules: optimize op '{op.type}' "
                        f"reads the ZeRO-sharded gradients {sorted(read)}, "
                        "of which each rank holds its rows only; an "
                        "optimize op but the parameter's own update and "
                        "AMP's check on sharded gradients waits for "
                        f"{_dp.GSPMD_ITEM}")
            params = list(zero)
            after.setdefault(last, []).append(_dp.all_gather_step(
                params, [zero[p] for p in params], group, size))
        return {first: before}, after, wraps

    def _host_step(self, op_type, device):
        """Whether an op of ``op_type`` (or a collective step) runs as a
        host step between graphs: a collective on gloo on the card."""
        from paddle_tpu_torch.ops.collective import COLLECTIVE_OPS

        if device.type != "cuda" or _penv.backend() == "nccl":
            return False
        if op_type in COLLECTIVE_OPS:
            return True
        dp = self._dp()
        return op_type in _BATCH_STAT_OPS and dp is not None and dp[1] > 1

    def _build_fn(self, fetch_names, device):
        """The plan of the global block: segments of device ops split at
        host-only ops (see the module docstring), with a data-parallel
        step's collectives and ZeRO's updates."""
        items, seg, constants = [], None, set()
        ops = self._program.global_block().ops
        before, after, wraps = self._dp_steps(ops)

        def add(step, host):
            nonlocal seg
            if host:
                seg = None
                items.append(_HostOp(step))
                return
            if seg is None:
                seg = _Segment()
                items.append(seg)
            seg.steps.append((step, None))

        for i, op in enumerate(ops):
            for step in before.get(i, ()):
                add(step, self._host_step(step.op.type, device))
            if op.type in _SKIP_IN_TRACE:
                continue
            if op.type in _CONTROL_FLOW:
                raise NotImplementedError(
                    f"compile: op '{op.type}' (control flow) has no port "
                    "yet; run this program through the interpreted "
                    "executor (ROADMAP Queue 1 item 6)")
            rop = ResolvedOp(op)
            if rop.op_def.host_only:
                seg = None
                if op.type not in _HOST_SKIP_SILENT:
                    items.append(_HostOp(rop))
                continue
            if i in wraps:
                rop = _dp.ZeroOpt(rop, wraps[i])
            if self._host_step(op.type, device):
                add(rop, True)
                for step in after.get(i, ()):
                    add(step, self._host_step(step.op.type, device))
                continue
            if seg is None:
                seg = _Segment()
                items.append(seg)
            const = None
            if not rop.input_names():
                const = rop.compute({}, device)
                rop.scatter(const, lambda n, v: constants.add(_storage(v)))
            seg.steps.append((rop, const))
            for step in after.get(i, ()):
                add(step, self._host_step(step.op.type, device))
        state = set(self._persistable_names)
        live = set(fetch_names)
        for item in reversed(items):
            if isinstance(item, _HostOp):
                live.update(item.rop.input_names())
                continue
            item.live_after = tuple(sorted(live))
            seen = set()
            for rop, _ in item.steps:
                for n in rop.output_names():
                    if n in state and n not in seen:
                        seen.add(n)
                        item.writes_state.append(n)
                live.update(rop.input_names())
        return _Entry(items, fetch_names, constants)

    # -- persistable buffers ----------------------------------------------
    def _bind_state(self, scope, device):
        """Make the scope's tensor of each persistable its fixed buffer
        (moved to ``device``, made dense or given a storage of its own
        where it is not); drops every entry built against other
        buffers."""
        self._cache.clear()
        self._pool = None
        self._scope, self._device = scope, device
        self._state, self._state_storages = {}, set()
        self._zero = self._zero_rows()
        self._rules_key = None
        acc_rows = {a: r for r in self._zero.values()
                    for a in r.accumulators}
        used = None
        for n in self._persistable_names:
            var = scope.find_var(n)
            r = acc_rows.get(n)
            if isinstance(var, _dp.ShardedVariable) and var.value is None:
                if r is not None and var.holds(r):
                    t = var.rows
                else:
                    if used is None:
                        used = {m for op in self._program.global_block().ops
                                for m in op.input_names() + op.output_names()}
                    if n not in used:
                        continue    # another program's rows, unread here
                    var.get()       # raises, naming ZeRO
            else:
                t = None if var is None else var.get()
                if t is None:
                    raise RuntimeError(
                        f"CompiledProgram: persistable '{n}' is "
                        "uninitialized — run the startup program first")
                if r is not None and t.shape[0] == r.rows_total:
                    t = t[r.lo:r.hi]
            if t.device != device or not t.is_contiguous() or \
                    _storage(t) in self._state_storages or r is not None:
                t = t.to(device).clone(memory_format=torch.contiguous_format)
            if r is not None:
                # ZeRO: this rank's rows stay here; the scope's entry
                # refuses a read
                _scope_holding(scope, n).vars[n] = _dp.ShardedVariable(
                    n, t, r)
            elif t is not var.get():
                var.set(t)
            self._state[n] = t
            self._state_storages.add(_storage(t))

    def sharded_state(self) -> dict:
        """{accumulator: this rank's rows} of the ZeRO-sharded optimizer
        state, once a run has bound it ({} without ZeRO)."""
        return {a: self._state[a] for r in self._zero.values()
                for a in r.accumulators if a in self._state}

    def _zero_rows(self):
        """{parameter: ZeroRows} of this rank under ZeRO's rule, or {}."""
        dp = self._dp()
        if self._sharding_fn is None or dp is None or dp[1] == 1:
            return {}
        index = self._mesh.axis_index(self._data_axis)
        block = self._program.global_block()
        return {p: _dp.ZeroRows(int(block.var(p).shape[0]), dp[1], index,
                                accs)
                for p, accs in _dp.zero_layout(
                    self._program, self._sharding_fn,
                    self._data_axis).items()}

    def _sync_state(self, scope, device):
        """Before a run: every persistable in the scope is its buffer.  A
        tensor set in a buffer's place is copied into it (same shape,
        dtype); anything else rebinds every buffer."""
        if scope is not self._scope or device != self._device:
            self._bind_state(scope, device)
            return
        for n, buf in self._state.items():
            var = scope.find_var(n)
            if isinstance(var, _dp.ShardedVariable) and var.rows is buf \
                    and var.value is None:
                continue
            t = None if var is None else var.get()
            if t is buf:
                continue
            if t is None:
                raise RuntimeError(
                    f"CompiledProgram: persistable '{n}' is uninitialized —"
                    " run the startup program first")
            if t.shape != buf.shape or t.dtype != buf.dtype:
                self._bind_state(scope, device)
                return
            buf.copy_(t)
            var.set(buf)

    def _write_back(self, seg, env):
        """The end of a segment: each persistable it rewrote is copied
        back into its buffer.  A value read later (or fetched) that views
        a buffer about to change is cloned first, and a new value that
        views any buffer is cloned before the copies, so the order of the
        copies changes nothing."""
        state = self._state
        rewritten = [n for n in seg.writes_state
                     if dict.get(env, n) is not state[n]]
        if not rewritten:
            return
        changing = {_storage(state[n]) for n in rewritten}
        for n in seg.live_after:
            v = dict.get(env, n)
            if isinstance(v, torch.Tensor) and n not in state and \
                    _storage(v) in changing:
                env[n] = v.clone()
        news = []
        for n in rewritten:
            v, buf = env[n], state[n]
            if v.shape != buf.shape or v.dtype != buf.dtype:
                raise RuntimeError(
                    f"CompiledProgram: the block writes persistable '{n}' "
                    f"as {tuple(v.shape)} {v.dtype}, its buffer is "
                    f"{tuple(buf.shape)} {buf.dtype}; the compiled path "
                    "keeps a persistable's shape and dtype")
            if _storage(v) in self._state_storages:
                v = v.clone()
            news.append((buf, v))
        for buf, v in news:
            buf.copy_(v)
        for n in rewritten:
            env[n] = state[n]

    # -- running the plan -------------------------------------------------
    def _run_segment(self, seg, env, device):
        for rop, const in seg.steps:
            outs = const if const is not None else rop.compute(
                rop.gather(env.get), device)
            rop.scatter(outs, env.__setitem__)
        self._write_back(seg, env)

    def _run_host(self, item, env, device):
        """A host-only op, eagerly (JAX ``_trace_host_op``: where it
        cannot run, its outputs are poisoned)."""
        rop = item.rop
        poisoned = next((n for n in rop.input_names() if env.poisoned(n)),
                        None)
        if rop.op.type in _SPECIAL_OPS:
            reason = ("it only runs through the interpreted executor's "
                      "special handler")
        elif poisoned is not None:
            reason = (f"its input '{poisoned}' is itself an unavailable "
                      "host-only product")
        else:
            try:
                ins = rop.gather(lambda n: dict.get(env, n))
            except RuntimeError:
                reason = "some inputs are missing in the plan"
            else:
                item.outputs = {}
                outs = rop.compute(ins, device)

                def put(n, v):
                    if n in self._state:
                        self._state[n].copy_(v)
                        v = self._state[n]
                    env[n] = item.outputs[n] = v

                rop.scatter(outs, put)
                return
        item.reason = reason
        self._poison_host(item, env)

    def _poison_host(self, item, env):
        for n in item.rop.output_names():
            if n in env:
                # value already supplied via state/feeds: keep it usable
                continue
            env.poison(
                n, f"op '{item.rop.op.type}' is host-only and cannot join "
                f"the compiled program ({item.reason}); run this program "
                "through the interpreted executor")

    def _run_eager(self, entry, env, device):
        for item in entry.items:
            if isinstance(item, _HostOp):
                self._run_host(item, env, device)
            else:
                self._run_segment(item, env, device)
        return [self._fetched(entry, env, f) for f in entry.fetch_names]

    def _fetched(self, entry, env, name):
        """The value of fetch ``name``, cloned where it views a buffer
        that a later run rewrites or a constant that every run reads."""
        v = env.get(name)
        if v is None:
            raise RuntimeError(f"fetch variable '{name}' has no value")
        s = _storage(v)
        if s in self._state_storages or s in entry.constants:
            v = v.clone()
        return v

    def _capture(self, entry, feeds, device):
        """Capture each segment of ``entry`` on the side stream (the
        current one), its inputs in fixed buffers; records each
        capture's launch deltas and the fetched tensors."""
        from paddle_tpu_torch.ops import kernel_launches

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        env = _TraceEnv(self._state)
        for n, t in feeds.items():
            entry.feed_buffers[n] = buf = torch.empty_like(
                t, device=device, memory_format=torch.contiguous_format)
            env[n] = buf
        for i, item in enumerate(entry.items):
            if isinstance(item, _HostOp):
                if item.outputs is None:       # poisoned in the eager run
                    self._poison_host(item, env)
                    continue
                item.ins = item.rop.gather(lambda n: dict.get(env, n))
                item.buffers = {}
                for n, v in item.outputs.items():
                    item.buffers[n] = env[n] = self._state[n] \
                        if n in self._state else torch.empty_like(v)
                item.outputs = None        # the eager run's tensors
                continue
            # thread-local mode: other threads' replays, fetches and
            # allocations go on beside it (the module docstring); the
            # device's lock keeps other warm-ups and captures, whose
            # launches would enter the deltas, out of it
            before = kernel_launches()
            graph = torch.cuda.CUDAGraph()
            torch.cuda.current_stream(device).synchronize()
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                self._run_segment(item, env, device)
            except BaseException as e:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass          # the capture is already invalid
                raise RuntimeError(
                    f"CompiledProgram: capturing segment {i} into a CUDA "
                    f"graph failed: {e}") from e
            graph.capture_end()
            after = kernel_launches()
            item.graph = graph
            item.launches = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
        entry.fetches = [env.get(f) for f in entry.fetch_names]

    def _replay(self, entry, feeds, device):
        """One replay; returns the fetched tensors, which the next replay
        overwrites (graph memory, persistable buffers or constants)."""
        for n, t in feeds.items():
            entry.feed_buffers[n].copy_(t, non_blocking=True)
        for item in entry.items:
            if isinstance(item, _Segment):
                item.graph.replay()
            elif item.buffers is not None:
                outs = item.rop.compute(item.ins, device)

                def put(n, v, item=item):
                    buf = item.buffers[n]
                    if v.shape != buf.shape or v.dtype != buf.dtype:
                        raise RuntimeError(
                            f"CompiledProgram: host op '{item.rop.op.type}'"
                            f" output '{n}' is {tuple(v.shape)} {v.dtype}; "
                            f"the captured graph reads it as "
                            f"{tuple(buf.shape)} {buf.dtype}")
                    buf.copy_(v)

                item.rop.scatter(outs, put)
        entry.replays += 1
        return entry.fetches

    def _new_entry(self, fetch_names, feeds, device):
        """Build a key's plan; on the card warm it up (the real first
        step, returned) on the side stream and capture it.  Returns the
        entry and the first step's fetches, which the caller owns."""
        entry = self._build_fn(fetch_names, device)
        env = _TraceEnv(self._state)
        if device.type != "cuda":
            env.update(feeds)
            return entry, self._run_eager(entry, env, device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            env.update({n: t.to(device, non_blocking=True)
                        for n, t in feeds.items()})
            # cloned on the side stream, whose work the caller's stream
            # waits for: nothing the warm-up allocated is read elsewhere
            fetched = [v.clone() for v in
                       self._run_eager(entry, env, device)]
            del env
            self._capture(entry, feeds, device)
        torch.cuda.current_stream(device).wait_stream(stream)
        return entry, fetched

    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        device = executor.device
        program = self._program
        feeds = {n: feed_tensor(program, n, v) for n, v in feed.items()}
        fetch_names = [fetch_name(f) for f in fetch_list]
        key = (
            tuple(sorted((k, tuple(v.shape), str(v.dtype))
                         for k, v in feeds.items())),
            tuple(fetch_names),
            _program_fingerprint(program),
        )
        tracer = _obs_trace._tracer
        lock = _device_lock(device)
        dp = self._dp()
        with self._lock, torch.no_grad(), (
                _penv.data_parallel(self._mesh, self._data_axis)
                if dp is not None else contextlib.nullcontext()):
            if dp is not None:
                self._check_batch(feeds, dp, device)
            self._sync_state(scope, device)
            entry = self._cache.get(key)
            if entry is not None:
                with lock.run():
                    t0 = time.perf_counter()
                    # the span and the device-trace annotation hold the
                    # fetch too: its copy to the host is the step's last
                    # transfer.  Copied out under the instance's lock,
                    # before its next replay
                    if tracer is not None:
                        with tracer.span("executor.step"), \
                                _obs_device.annotate("executor.step"):
                            return self._fetch(
                                self._step(entry, feeds, device),
                                fetch_names, return_numpy, t0,
                                device.type == "cuda")
                    return self._fetch(self._step(entry, feeds, device),
                                       fetch_names, return_numpy, t0,
                                       device.type == "cuda")
            # a cache miss: a new (shapes, fetch, program) entry, its
            # warm-up and capture alone among the device's (the module
            # docstring)
            with lock.capture():
                t0 = time.perf_counter()
                _M_COMPILES.inc()
                _obs_flight.record("executor", "compile",
                                   n_feeds=len(feeds),
                                   n_fetch=len(fetch_names))
                if tracer is not None:
                    with tracer.span("executor.compile"), \
                            _obs_device.annotate("executor.compile"):
                        entry, fetched = self._new_entry(fetch_names,
                                                         feeds, device)
                else:
                    entry, fetched = self._new_entry(fetch_names, feeds,
                                                     device)
                self._cache[key] = entry
                return self._fetch(fetched, fetch_names, return_numpy, t0,
                                   False)

    def _step(self, entry, feeds, device):
        """A cached key's run: eager on the CPU, a replay on the card."""
        if device.type != "cuda":
            env = _TraceEnv(self._state)
            env.update(feeds)
            return self._run_eager(entry, env, device)
        return self._replay(entry, feeds, device)

    def _check_batch(self, feeds, dp, device):
        """A data-parallel step's feeds: every rank's local batch (dim 0 of
        each feed) must be the same, so the global batch divides evenly
        over the data axis.  One all-gather of the sizes, every step."""
        group, size = dp
        names = sorted(n for n, t in feeds.items() if t.dim() >= 1)
        if size == 1 or not names:
            return
        on = device if _penv.backend() == "nccl" else torch.device("cpu")
        got = _penv.collective("all_gather", torch.tensor(
            [feeds[n].shape[0] for n in names], dtype=torch.int64,
            device=on), group, size).cpu()
        for j, n in enumerate(names):
            col = got[:, j].tolist()
            if len(set(col)) > 1:
                raise ValueError(
                    f"data-parallel feed '{n}': local batches {col} of the "
                    f"{size} ranks do not divide the global batch "
                    f"({sum(col)}) evenly over the '{self._data_axis}' "
                    "axis; feed an evenly divisible per-process shard")

    def _dp_fetched(self, fetched, fetch_names):
        """A data-parallel step's fetches made global (the module
        docstring's rules)."""
        group, size = self._dp()
        block = self._program.global_block()
        persist, grads, rows = self._fetch_rules()
        out = []
        for v, n in zip(fetched, fetch_names):
            if n == self._loss_name:
                v = _penv.collective("all_reduce", v, group, size) / size
            elif n in rows and v.shape[0] != rows[n].rows_total:
                v = _dp.gather_rows(v, rows[n], group, size)
            elif n in persist or n in grads:
                pass
            elif v.dim() >= 1 and block.has_var(n) and \
                    block.var(n).shape and block.var(n).shape[0] in (-1,
                                                                     None):
                got = _penv.collective("all_gather", v, group, size)
                v = got.reshape((size * v.shape[0],) + tuple(v.shape[1:]))
            else:
                raise _dp.DataParallelFetchError(n)
            out.append(v)
        return out

    def _fetch_rules(self):
        """(persistables, reduced gradients, {name: ZeroRows} of the
        ZeRO-sharded accumulators and gradients), once a program
        fingerprint and binding."""
        key = _program_fingerprint(self._program)
        if self._rules_key != key:
            block = self._program.global_block()
            _, grads = _dp.step_grads(block.ops)
            rows = {a: r for r in self._zero.values()
                    for a in r.accumulators}
            for op in block.ops:
                if "Grad" in op.inputs and "Param" in op.inputs:
                    rows.update((g, self._zero[p]) for p, g in zip(
                        op.inputs["Param"], op.inputs["Grad"])
                        if p in self._zero)
            self._rules = (set(self._persistable_names), set(grads), rows)
            self._rules_key = key
        return self._rules

    def _fetch(self, fetched, fetch_names, return_numpy, t0, replayed):
        """The run's fetches as the caller asked: numpy arrays, or tensors
        (a replay's cloned, since the next replay overwrites them); a
        data-parallel step's made global first.  Observes the step's
        seconds first, then requests the trainer's fleet push: a step
        boundary is its moment (rate-limited inside, the push runs on the
        pusher's thread; one None check and one memo check when off)."""
        if self._dp() is not None:
            fetched = self._dp_fetched(fetched, fetch_names)
        _M_STEP_SECONDS.observe(time.perf_counter() - t0)
        _obs_collector.maybe_step_push()
        if return_numpy:
            return [to_numpy(v, n) for v, n in zip(fetched, fetch_names)]
        if replayed:
            return [v.clone() for v in fetched]
        return fetched
