"""Inference engine: Config + Predictor over a saved inference model.

Counterpart of ``paddle_tpu/inference/__init__.py`` (``:30-279``,
``:365-412``, ``:420-425``).  A ``Config`` runs on the GPU by default;
``Config.disable_gpu()`` selects the CPU.  With no CUDA device and no
``disable_gpu()``, ``create_predictor`` raises ``NoCUDADeviceError``.

The Predictor loads the parameters onto its device once, runs the
analysis passes when ``ir_optim`` is on (in the JAX order: the conv+bn
fold, the fc fusion, the elementwise-add + act fusion), casts the
program to bf16 after ``enable_mkldnn_bfloat16``, validates every feed
against the program's feed targets, and interprets the program op by
op on its device.  The passes name the vars they add with the lowest
suffix the program does not hold, so loading one directory twice gives
one program (one ``program_fingerprint``) whatever ran before.  The
knobs that map to TensorRT, MKLDNN, feed/fetch ops, memory optimisation
and glog are recorded and change nothing, as in the JAX package, so
reference config scripts run unchanged.

The swap surface (``program_fingerprint``, ``program_state``,
``swap_program``) lets the serving pool move a replica's Predictor onto
another program and back.  ``shard`` (behind the ``serving_sharded``
flag) splits the fc weights column-parallel over a ``MeshPlan``'s tp
ranks, one process a device, and ``sharding_info`` reports the blocks.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

__all__ = ["Config", "AnalysisConfig", "Predictor", "PaddleTensor",
           "FeedValidationError", "create_predictor",
           "create_paddle_predictor"]


class FeedValidationError(ValueError):
    """A feed's name, shape or dtype does not match the program's feed
    target; raised by ``Predictor.run`` before any op runs."""


class Config:
    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self._ir_optim = True
        self._model_dir = model_dir
        self._prog_file = prog_file
        self._params_file = params_file
        self._use_gpu = True
        self._gpu_device_id = 0
        self._use_feed_fetch_ops = False
        self._memory_optim = True
        self._glog_info = True
        self._bf16 = False

    def set_model(self, model_dir_or_prog, params_file=None):
        if params_file is None:
            self._model_dir = model_dir_or_prog
        else:
            self._prog_file = model_dir_or_prog
            self._params_file = params_file
            self._model_dir = os.path.dirname(model_dir_or_prog)

    def model_dir(self):
        return self._model_dir

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on CUDA device ``device_id`` (the default is device 0).
        The memory pool size is PyTorch's caching allocator's business
        and is ignored."""
        self._use_gpu = True
        self._gpu_device_id = device_id

    def disable_gpu(self):
        """Run on the CPU."""
        self._use_gpu = False

    def switch_ir_optim(self, enable=True):
        """Toggle the analysis passes run on load (on by default): the
        conv+bn fold, the fc fusion, the elementwise-add + act fusion."""
        self._ir_optim = bool(enable)

    def enable_mkldnn_bfloat16(self):
        """Fold the parameters to bfloat16 and run the program in bf16
        (``contrib.float16.bf16_transpile``), as the JAX package does."""
        self._bf16 = True

    # -- recorded no-ops for API parity ----------------------------------
    def enable_tensorrt_engine(self, *args, **kwargs):
        pass

    def enable_mkldnn(self):
        pass

    def switch_use_feed_fetch_ops(self, enable=True):
        self._use_feed_fetch_ops = enable

    def enable_memory_optim(self, enable=True):
        self._memory_optim = enable

    def disable_glog_info(self):
        self._glog_info = False

    def place(self):
        from paddle_tpu_torch.core.types import CPUPlace, CUDAPlace

        return CUDAPlace(self._gpu_device_id) if self._use_gpu \
            else CPUPlace()


AnalysisConfig = Config


class PaddleTensor:
    """Input/output handle (PaddleTensor + ZeroCopyTensor surface)."""

    def __init__(self, name=None, data=None):
        self.name = name
        self._data = None if data is None else np.asarray(data)

    def copy_from_cpu(self, arr):
        self._data = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        return self._data

    def reshape(self, shape):
        if self._data is not None:
            self._data = self._data.reshape(shape)

    @property
    def shape(self):
        return None if self._data is None else list(self._data.shape)

    def data(self):
        return self._data


class Predictor:
    def __init__(self, config: Config):
        from paddle_tpu_torch import io
        from paddle_tpu_torch.core.compiler import CompiledProgram
        from paddle_tpu_torch.core.executor import Executor
        from paddle_tpu_torch.core.scope import Scope, scope_guard

        self._config = config
        self._scope = Scope()
        self._exe = Executor(config.place())
        model_dir = config.model_dir()
        if model_dir is None:
            raise ValueError("Config.set_model was not called")
        kwargs = {}
        if config._prog_file:
            kwargs["model_filename"] = os.path.basename(config._prog_file)
        if config._params_file:
            kwargs["params_filename"] = os.path.basename(
                config._params_file)
        with scope_guard(self._scope):
            self._program, self._feed_names, self._fetch_vars = \
                io.load_inference_model(model_dir, self._exe, **kwargs)
        if config._ir_optim:
            from paddle_tpu_torch.transpiler import (
                FuseElewiseAddActTranspiler, FuseFCTranspiler,
                InferenceTranspiler)

            protected = set(self._feed_names) | {
                v.name for v in self._fetch_vars}
            InferenceTranspiler().transpile(self._program, scope=self._scope,
                                            protected=protected)
            FuseFCTranspiler().transpile(self._program, protected=protected)
            FuseElewiseAddActTranspiler().transpile(self._program,
                                                    protected=protected)
        if config._bf16:
            from paddle_tpu_torch.contrib.float16 import bf16_transpile

            bf16_transpile(self._program, scope=self._scope)
        self._compiled = CompiledProgram(self._program) \
            .with_inference_optimize(config)
        self._inputs = {n: PaddleTensor(n) for n in self._feed_names}
        self._outputs = {}
        # feed target specs for run()-time validation: (shape, dtype
        # name) per feed; shape dims < 0 (the batch dim) are wildcards
        self._feed_specs = {}
        block = self._program.global_block()
        for n in self._feed_names:
            if not block.has_var(n):
                continue
            v = block.var(n)
            if v.shape is not None and v.dtype is not None:
                self._feed_specs[n] = (tuple(v.shape), v.dtype)

    @property
    def device(self):
        return self._exe.device

    def get_input_names(self):
        return list(self._feed_names)

    def get_input_handle(self, name):
        return self._inputs[name]

    get_input_tensor = get_input_handle

    def get_output_names(self):
        return [v.name for v in self._fetch_vars]

    def get_output_handle(self, name):
        return self._outputs[name]

    get_output_tensor = get_output_handle

    def feed_specs(self):
        """{feed name: (shape, dtype name)}; dims < 0 accept any extent."""
        return dict(self._feed_specs)

    def validate_feed(self, name, value):
        """Raise FeedValidationError (one line, naming the feed) when
        ``value`` can't feed target ``name``; returns the ndarray."""
        if name not in self._feed_names:
            raise FeedValidationError(
                f"feed '{name}': not a feed target (expected one of "
                f"{sorted(self._feed_names)})")
        arr = np.asarray(value)
        if name not in self._feed_specs:
            return arr
        shape, dtype = self._feed_specs[name]
        if str(arr.dtype) != dtype:
            raise FeedValidationError(
                f"feed '{name}': dtype {arr.dtype} does not match the "
                f"program's feed target dtype {dtype}")
        if len(arr.shape) != len(shape) or any(
                d >= 0 and a != d for a, d in zip(arr.shape, shape)):
            raise FeedValidationError(
                f"feed '{name}': shape {tuple(arr.shape)} does not match "
                f"the program's feed target shape {shape} (dims < 0 are "
                "free)")
        return arr

    def validate_feeds(self, feeds):
        """Validate a {name: array} dict: every feed target present, no
        extras, every array shape/dtype-conformant."""
        missing = set(self._feed_names) - set(feeds)
        if missing:
            raise FeedValidationError(
                f"missing feeds {sorted(missing)} (feed targets: "
                f"{sorted(self._feed_names)})")
        return {n: self.validate_feed(n, v) for n, v in feeds.items()}

    def run(self, inputs=None):
        """inputs: PaddleTensors or ndarrays in get_input_names() order,
        or None to use the handles filled via copy_from_cpu.  Returns the
        fetches as ndarrays (also readable via get_output_handle)."""
        feed = {}
        if inputs is not None:
            if len(inputs) != len(self._feed_names):
                raise FeedValidationError(
                    f"expected {len(self._feed_names)} inputs "
                    f"({self._feed_names}), got {len(inputs)}")
            for name, t in zip(self._feed_names, inputs):
                feed[name] = t.data() if isinstance(t, PaddleTensor) \
                    else t
        else:
            for name, t in self._inputs.items():
                if t.data() is None:
                    raise RuntimeError(
                        f"input '{name}' not set; call copy_from_cpu")
                feed[name] = t.data()
        feed = {n: self.validate_feed(n, v) for n, v in feed.items()}
        from paddle_tpu_torch.observability import tracing as _trace

        # joins the serving.replica span through the thread-local stack
        # when a pool worker calls it
        with _trace._tracer.span("predictor.run") \
                if _trace._tracer is not None else contextlib.nullcontext():
            outs = self._exe.run(self._compiled, feed=feed,
                                 fetch_list=self._fetch_vars,
                                 scope=self._scope)
        self._outputs = {v.name: PaddleTensor(v.name, o)
                         for v, o in zip(self._fetch_vars, outs)}
        return outs

    zero_copy_run = run

    # -- tensor-parallel sharding over the world's ranks ------------------
    def shard(self, plan, devices=None, axis="tp"):
        """Shards this Predictor over ``plan``'s ranks (one process a
        device; ``devices``, when given, one a rank): the inference
        program's fc weights annotated column-parallel over the plan's
        ``axis`` (``parallel.gspmd.annotate_tp_inference``), the
        annotations' rules installed on the compiled program, and each
        rank keeping its column block of each annotated weight and bias
        from now on.  A run gathers the activation after each split layer
        and every rank returns the whole output.  Column-only splits keep
        every contraction full-width.

        Behind the typed ``serving_sharded`` flag: with it off this is a
        no-op returning None (no byte of the program changes).
        Idempotent.  Returns {"annotated": [...], "devices": n}."""
        from paddle_tpu_torch.flags import get_flag

        if not get_flag("serving_sharded"):
            return None
        from paddle_tpu_torch.parallel.gspmd import (MeshPlan,
                                                     annotate_tp_inference,
                                                     partition_spec_of)

        if not isinstance(plan, MeshPlan):
            raise TypeError(f"plan must be a MeshPlan, got {plan!r}")
        annotated = annotate_tp_inference(self._program, plan, axis=axis)
        mesh = plan.build_mesh(devices=devices)
        program = self._program

        def rule(name, shape):
            var = program.global_block().vars.get(name)
            if var is None:
                return None
            return partition_spec_of(var, plan, shape=shape)

        self._compiled.with_sharding_rules(rule, mesh=mesh)
        # the blocks now: each rank keeps its block of each annotated var
        self._compiled._bind_state(self._scope, self.device)
        self._mesh_plan = plan
        self._tp_annotated = annotated
        return {"annotated": annotated, "devices": plan.size()}

    def sharding_info(self):
        """{param: (spec, this rank's block shape)} of the annotated params
        of a sharded Predictor ({} unsharded)."""
        blocks = self._compiled.sharded_state()
        block = self._program.global_block()
        return {n: (tuple(block.var(n).sharding), tuple(blocks[n].shape))
                for n in getattr(self, "_tp_annotated", ()) or ()
                if n in blocks}

    # -- live program swap (the serving pool's swap_predictor) -------------
    # what a snapshot carries: the CompiledProgram with the Scope its
    # captured graphs read at fixed addresses, and the Executor whose
    # place they run on
    _SWAP_ATTRS = ("_program", "_feed_names", "_fetch_vars", "_compiled",
                   "_scope", "_exe", "_inputs", "_feed_specs")

    def program_fingerprint(self):
        """Structural content hash of the loaded program, the value the
        compiled cache keys on (``core.compiler.program_fingerprint``); a
        rollback restores the exact old value."""
        from paddle_tpu_torch.core.compiler import program_fingerprint

        return program_fingerprint(self._program)

    def program_state(self):
        """Snapshot of the swappable surface (``_SWAP_ATTRS``): the token
        ``swap_program`` takes to restore this exact program later.  Its
        CompiledProgram keeps its graphs, so a swap back replays them
        with no new capture."""
        return {a: getattr(self, a) for a in self._SWAP_ATTRS}

    def swap_program(self, source):
        """Swap this Predictor onto another program in place: ``source``
        is another Predictor or a ``program_state()`` snapshot.  The
        object survives, so the server's feed validator and the replica
        see the new program; the old state is returned for rollback.

        The caller guarantees that no ``run()`` is in flight (the pool
        swaps only a replica quiesced through its per-replica drain,
        ``ReplicaPool.swap_predictor``)."""
        state = source if isinstance(source, dict) \
            else source.program_state()
        missing = [a for a in self._SWAP_ATTRS if a not in state]
        if missing:
            raise ValueError(
                "swap_program: source state missing %s" % missing)
        prior = self.program_state()
        for a in self._SWAP_ATTRS:
            setattr(self, a, state[a])
        return prior


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


create_paddle_predictor = create_predictor
