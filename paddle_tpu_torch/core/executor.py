"""Serial op-by-op executor over torch tensors.

Counterpart of ``paddle_tpu/core/executor.py`` (``Executor.run`` and the
interpreter loop, ``:57-267``).  Every op's compute runs eagerly on the
executor's device; feeds are moved there, fetches come back as numpy
when ``return_numpy`` is set (bfloat16 as ``ml_dtypes`` bfloat16
arrays, as the JAX package returns them).

A ``CompiledProgram`` goes to its own ``_run`` (the plan and its CUDA
graphs, ``core/compiler.py``); a plain ``Program`` is interpreted here,
the debug path, where the flags ``profile_ops`` (a ``RecordEvent`` span
an op) and ``check_nan_inf`` (``FloatingPointError`` naming the output
and the op) act, as in the JAX package.  Both resolve ops through
``ResolvedOp``, so they run one contract.  Host ops with a handler of
their own (``register_special_op``: saves, loads, the parameter-server
ops) run only here, with the JAX package's ``(op, block, scope, ctx)``
signature; ``CompiledProgram`` leaves them out of its plan.  An
``Executor.run`` is a trainer's step boundary, where the fleet
collector's step push is requested (``observability/collector.py``).

Every op runs under ``torch.no_grad()``: the forward keeps no autograd
graph and no scope tensor requires grad.  Only a synthesised
``<op>_grad`` compute turns grad mode on, inside itself
(``core/registry.py``).  An op's outputs are stored under their own
names; an optimizer's ``ParamOut`` is named after its ``Param``, so here
the new tensor replaces the old one in the scope (no update in place;
the compiled path copies it back into the persistable's fixed buffer).

``train_from_dataset`` (JAX ``core/executor.py:269-375``) drives a
``Dataset``: the trainer descriptor from ``program._fleet_opt`` picks
the loop.  ``DownpourSGD`` hands it to a ``DownpourRunner``
(``distributed/downpour_worker.py``: pull, forward and backward, async
push against the parameter servers); otherwise batches come through a
``DeviceFeeder`` (``reader.py``), on the card ahead of the step, into
``run``.

``Executor()`` with no place means ``CUDAPlace(0)`` (a rank of a
collective job: its own device, ``parallel.env``); resolving it raises
``NoCUDADeviceError`` when no CUDA device is present, so nothing runs on
the CPU unless the caller passed ``CPUPlace()``.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.program import Program
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.core.scope import Scope, global_scope
from paddle_tpu_torch.core.types import (CUDAPlace, Place, from_numpy,
                                         to_numpy, to_torch_dtype)
from paddle_tpu_torch.observability import collector as _collector

# op types executed by a python handler instead of a registry compute
# (host IO: save/load of parameters; the parameter-server ops).  A
# handler takes the JAX package's ``(op, block, scope, ctx)``: ``ctx``
# gives the executor's device and runs sub-blocks (listen_and_serv's
# optimize blocks)
_SPECIAL_OPS: dict = {}


def register_special_op(type: str):
    def deco(fn):
        _SPECIAL_OPS[type] = fn
        return fn

    return deco


class RuntimeCtx:
    """Handed to special ops: the program being run, the executor's
    device, and ``run_block`` to run one of the program's sub-blocks
    (JAX ``core/executor.py`` ``RuntimeCtx``)."""

    def __init__(self, executor, program):
        self.executor = executor
        self.program = program
        self.device = executor.device

    def run_block(self, block_idx: int, scope: Scope):
        block = self.program.blocks[block_idx]
        with torch.no_grad():
            for op in block.ops:
                self.executor._run_op(op, block, scope, self)


class ResolvedOp:
    """One op with its ``OpDef`` and slots looked up once: the contract
    the interpreter and ``CompiledProgram``'s plan share.  ``gather``
    builds the compute's ``ins`` from ``get(name) -> tensor or None``
    (optional and empty slots are left out, a missing input raises),
    ``compute`` runs it, ``scatter`` hands each output to ``put(name,
    tensor)``."""

    __slots__ = ("op", "op_def", "inputs", "outputs")

    def __init__(self, op):
        self.op = op
        self.op_def = op_def = get_op_def(op.type)
        self.inputs = tuple(
            (slot, tuple(names), slot in op_def.duplicable,
             slot in op_def.optional)
            for slot, names in op.inputs.items())
        self.outputs = tuple((slot, tuple(names))
                             for slot, names in op.outputs.items())

    def input_names(self):
        return [n for _, names, _, _ in self.inputs for n in names]

    def output_names(self):
        return [n for _, names in self.outputs for n in names]

    def gather(self, get):
        ins = {}
        for slot, names, duplicable, optional in self.inputs:
            if duplicable:
                vals = [get(n) for n in names]
                missing = [n for n, v in zip(names, vals) if v is None]
                if missing:
                    if optional:
                        continue
                    raise RuntimeError(
                        f"op {self.op.type}: input slot {slot} vars "
                        f"{missing} are unset")
                ins[slot] = vals
            else:
                val = get(names[0]) if names else None
                if val is None:
                    if optional or not names:
                        continue
                    raise RuntimeError(
                        f"op {self.op.type}: input '{names[0]}' (slot "
                        f"{slot}) is unset")
                ins[slot] = val
        return ins

    def compute(self, ins, device):
        try:
            return self.op_def.compute(ins, self.op.attrs, device)
        except Exception as e:
            raise RuntimeError(
                f"error running op {self.op.type} ({self.op!r}): {e}") from e

    def scatter(self, outs, put):
        for slot, names in self.outputs:
            if slot not in outs:
                continue
            vals = outs[slot]
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for n, v in zip(names, vals):
                put(n, v)


def _scope_value(scope: Scope, name):
    var = scope.find_var(name)
    return None if var is None else var.get()


class Executor:
    """Runs a Program's global block op by op on ``place``'s device, or
    hands a ``CompiledProgram`` to its own ``_run``."""

    def __init__(self, place: Place = None):
        if place is None:
            from paddle_tpu_torch.parallel import env as penv

            # a rank of a collective job takes its own device
            place = CUDAPlace(penv.default_device_id())
        self.place = place
        self.device = self.place.torch_device()

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        from paddle_tpu_torch import framework
        from paddle_tpu_torch.core.compiler import CompiledProgram

        if program is None:
            program = framework.default_main_program()
        if scope is None:
            scope = global_scope()
        if isinstance(program, CompiledProgram):
            return program._run(self, dict(feed or {}), fetch_list or [],
                                scope, return_numpy)
        self._feed_data(program, feed or {}, scope)
        ctx = RuntimeCtx(self, program)
        block = program.global_block()
        with torch.no_grad():
            for op in block.ops:
                self._run_op(op, block, scope, ctx)
        out = self._fetch(fetch_list or [], scope, return_numpy)
        # the trainer's fleet push: an Executor.run is the step boundary
        # of the interpreted path (the compiled path pushes from its
        # step); one None check and one memo check when off
        _collector.maybe_step_push()
        return out

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Dataset-driven training (reference executor.py:927
        train_from_dataset -> framework/executor.cc:120 RunFromDataset).

        The trainer descriptor comes from ``program._fleet_opt`` through
        ``TrainerFactory``, as in the reference's ``_prepare_trainer``.
        Its ``DownpourSGD`` worker runs the Downpour loop: the runner in
        ``_fleet_opt["downpour_runner"]``, else one made from the
        transpiler in ``_fleet_opt["transpiler"]``, else one from a
        transpile of ``program`` by fleet's role contract (its pserver
        endpoints, worker index and count; async mode).  Otherwise the
        dataset's batches run through ``run`` one by one, each put on
        the device ahead of its step by a ``DeviceFeeder``.  Returns
        None, as the JAX package does."""
        from paddle_tpu_torch import framework
        from paddle_tpu_torch.reader import DeviceFeeder
        from paddle_tpu_torch.trainer_desc import TrainerFactory

        if dataset is None:
            raise ValueError("dataset is required")
        if program is None:
            program = framework.default_main_program()
        if scope is None:
            scope = global_scope()
        if thread:
            dataset.set_thread(thread)
        fetch_list = fetch_list or []
        fetch_info = fetch_info or [fetch_name(f) for f in fetch_list]
        opt_info = getattr(program, "_fleet_opt", None) or {}
        trainer = TrainerFactory()._create_trainer(opt_info)
        trainer._set_program(program)
        trainer._set_thread(thread or dataset._thread)
        trainer._set_debug(debug)
        trainer._set_fetch_var_and_info(fetch_list, fetch_info, print_period)
        trainer._gen_trainer_desc()
        runner = opt_info.get("downpour_runner")
        if runner is None and opt_info.get("device_worker") == "DownpourSGD":
            runner = self._downpour_runner(program, scope, opt_info)
        if runner is not None:
            runner.train_from_dataset(dataset, fetch_list)
            return None
        step = 0
        feeder = DeviceFeeder(dataset._iter_batches(),
                              capacity=max(4, 2 * (thread or 1)),
                              place=self.place)
        try:
            for feed in feeder:
                results = self.run(program, feed=feed,
                                   fetch_list=fetch_list, scope=scope)
                step += 1
                if debug and fetch_list and step % print_period == 0:
                    msg = ", ".join(
                        f"{name}={val.ravel()[:4]}"
                        for name, val in zip(fetch_info, results))
                    print(f"step {step}: {msg}")
        finally:
            feeder.stop()
        return None

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """reference executor.py infer_from_dataset (the same loop; the
        test-mode program is the caller's, by ``Program.clone(True)``)."""
        return self.train_from_dataset(program, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period)

    def _downpour_runner(self, program, scope, opt_info):
        """The Downpour runner of ``program``'s ``_fleet_opt``, made once
        and kept there (``downpour_runner``)."""
        from paddle_tpu_torch.distributed.downpour_worker import (
            DownpourRunner)

        t = opt_info.get("transpiler")
        if t is None:
            # the fleet role contract (reference: the pslib fleet init is
            # what wires DownpourWorker to its parameter servers)
            from paddle_tpu_torch.fleet import fleet
            from paddle_tpu_torch.transpiler import (
                DistributeTranspiler, DistributeTranspilerConfig)

            rm = fleet._role_maker
            eps = ",".join(rm.get_pserver_endpoints()) if rm else ""
            if not eps:
                raise RuntimeError(
                    "DownpourSGD device worker needs parameter servers: "
                    "fleet.init(role_maker) with pserver endpoints, or a "
                    "configured DistributeTranspiler in "
                    "program._fleet_opt['transpiler'] (async mode), or a "
                    "ready DownpourRunner in ['downpour_runner']")
            cfg = DistributeTranspilerConfig()
            cfg.sync_mode = False
            t = DistributeTranspiler(cfg)
            t.transpile(rm.worker_index(), program=program, pservers=eps,
                        trainers=rm.worker_num(), sync_mode=False)
            opt_info["transpiler"] = t
        runner = DownpourRunner(
            t, program=program, scope=scope, executor=self,
            push_window=int(opt_info.get("push_window", 4)),
            pull_dense_every=int(opt_info.get("pull_dense_every", 1)))
        opt_info["downpour_runner"] = runner
        return runner

    def _feed_data(self, program: Program, feed, scope: Scope):
        for name, value in feed.items():
            scope.var(name).set(feed_tensor(program, name, value).to(
                self.device, non_blocking=True))

    def _run_op(self, op, block, scope: Scope, ctx: RuntimeCtx):
        from paddle_tpu_torch import flags

        if flags.get_flag("profile_ops"):
            from paddle_tpu_torch import profiler

            with profiler.RecordEvent(op.type):
                self._run_op_inner(op, block, scope, ctx)
        else:
            self._run_op_inner(op, block, scope, ctx)
        if flags.get_flag("check_nan_inf"):
            self._check_nan_inf(op, scope)

    def _check_nan_inf(self, op, scope: Scope):
        """reference FLAGS_check_nan_inf sweep (operator.cc:953-983)."""
        for names in op.outputs.values():
            for n in names:
                val = _scope_value(scope, n)
                if not isinstance(val, torch.Tensor):
                    continue
                if val.is_floating_point() and \
                        not bool(torch.isfinite(val).all()):
                    raise FloatingPointError(
                        f"NaN/Inf in output '{n}' of op {op.type} "
                        f"({op!r})")

    def _run_op_inner(self, op, block, scope: Scope, ctx: RuntimeCtx):
        special = _SPECIAL_OPS.get(op.type)
        if special is not None:
            special(op, block, scope, ctx)
            return
        rop = ResolvedOp(op)
        outs = rop.compute(rop.gather(lambda n: _scope_value(scope, n)),
                           self.device)
        rop.scatter(outs, lambda n, v: scope.var(n).set(v))

    def _fetch(self, fetch_list, scope: Scope, return_numpy):
        results = []
        for f in fetch_list:
            name = fetch_name(f)
            val = _scope_value(scope, name)
            if val is None:
                raise RuntimeError(f"fetch variable '{name}' has no value")
            results.append(to_numpy(val, name) if return_numpy else val)
        return results


def fetch_name(f) -> str:
    return f if isinstance(f, str) else f.name


def feed_tensor(program: Program, name, value) -> torch.Tensor:
    """Feed ``value`` (an array or a tensor) as a tensor, where it lies,
    in the dtype the program declares for var ``name``."""
    if not isinstance(value, torch.Tensor):
        value = from_numpy(value, name)
    block = program.global_block()
    if block.has_var(name) and block.var(name).dtype is not None:
        value = value.to(to_torch_dtype(block.var(name).dtype))
    return value
