"""Fleet: the unified distributed-training facade, collective and
parameter-server modes.

Counterpart of ``paddle_tpu/fleet/__init__.py``.

The collective mode: ``init`` brings ``torch.distributed`` up from the
``PADDLE_*`` contract when there is more than one worker (rank
``PADDLE_TRAINER_ID`` of ``PADDLE_TRAINERS_NUM``, the store at
``PADDLE_COORDINATOR_ENDPOINT``, else at the first trainer endpoint; the
backend by ``parallel.env``'s rule; a second ``init`` changes nothing, as
in the JAX package, which brings ``jax.distributed`` up there).
``distributed_optimizer(...).minimize(loss)`` builds the normal program
and ``main_program`` is then a ``CompiledProgram`` over it in data
parallelism (ZeRO's rules with ``strategy.zero_stage``), which each rank
runs on its shard of the batch (``python -m paddle_tpu_torch.launch``
starts the ranks).  ``barrier_worker`` is a barrier across the workers.

The parameter-server mode: ``distributed_optimizer`` with ``strategy.mode =
"pserver"`` (or a role maker naming pserver endpoints) returns a
``ParameterServerOptimizer`` whose ``minimize`` transpiles the program
with ``DistributeTranspiler``; a server then runs ``init_server()`` (its
startup, optionally warm-started from the shards a ``checkpoint_notify``
wrote) and ``run_server()`` (``listen_and_serv`` until every trainer
completed); a worker runs ``startup_program`` and ``main_program``.
Servers run on ``CUDAPlace(0)`` unless ``place`` names another place
(the JAX package's servers run on the CPU).

Reference parity (SURVEY.md §2.4 "Fleet API"):
  - Fleet base + fleet.init/distributed_optimizer/minimize:
    python/paddle/fluid/incubate/fleet/base/fleet_base.py:37,230
  - collective impl: incubate/fleet/collective/__init__.py:215
    (CollectiveOptimizer)
  - the parameter-server optimizer:
    incubate/fleet/parameter_server/distribute_transpiler/__init__.py
  - role makers: incubate/fleet/base/role_maker.py
"""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.fleet.role_maker import (
    PaddleCloudRoleMaker,
    Role,
    RoleMakerBase,
    UserDefinedRoleMaker,
)

__all__ = ["fleet", "DistributedStrategy", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "RoleMakerBase", "Role",
           "CollectiveOptimizer"]


class DistributedStrategy:
    """reference collective DistributedStrategy knobs: ``mode``,
    ``use_amp`` with ``amp_loss_scaling`` and ``zero_stage`` (1, 2 or 3)
    drive the collective mode, ``sync_mode`` the
    parameter-server mode; the rest are kept for introspection (the
    gradients always ride one bucket a dtype, as if
    ``fuse_all_reduce_ops``)."""

    def __init__(self):
        self.mode = "collective"
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.fuse_all_reduce_ops = True
        self.forward_recompute = False
        self.recompute_checkpoints = []
        self.use_amp = False
        self.amp_loss_scaling = 2 ** 15
        self.sync_mode = True  # PS mode: sync vs fully-async
        self.zero_stage = 0


class _Fleet:
    def __init__(self):
        self._role_maker = None
        self._strategy = None
        self._compiled = None
        self._origin_program = None
        self._transpiler = None
        self._ps_startup = None
        self._ps_main = None
        self._is_initialized = False

    # -- lifecycle (reference fleet_base.py Fleet) ------------------------
    def init(self, role_maker=None, place=None):
        """``place``: this rank's device for a collective job (default:
        ``cuda:(local rank % device count)``; a CPU place runs on gloo)."""
        if role_maker is None:
            role_maker = PaddleCloudRoleMaker(is_collective=True)
        role_maker.generate_role()
        self._role_maker = role_maker
        self._maybe_init_distributed(place)
        self._is_initialized = True
        return self

    def _maybe_init_distributed(self, place):
        """A collective job of more than one worker: bring
        ``torch.distributed`` up from the PADDLE_* contract (the JAX
        package brings ``jax.distributed`` up here).  Parameter-server
        processes are no part of it."""
        from paddle_tpu_torch.parallel import env as penv

        rm = self._role_maker
        if rm.is_server() or rm.get_pserver_endpoints():
            return
        n = rm.worker_num()
        if n <= 1:
            return
        eps = rm.get_trainer_endpoints()
        coordinator = os.environ.get("PADDLE_COORDINATOR_ENDPOINT") or (
            eps[0] if eps else None)
        if not coordinator:
            raise RuntimeError(
                "fleet.init: a collective job of more than one worker needs "
                "PADDLE_COORDINATOR_ENDPOINT or PADDLE_TRAINER_ENDPOINTS")
        penv.init_parallel_env(rm.worker_index(), n, coordinator,
                               place=place, endpoints=eps,
                               current=rm.get_current_endpoint())

    # -- introspection ----------------------------------------------------
    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def worker_endpoints(self):
        return self._role_maker.get_trainer_endpoints()

    def server_endpoints(self):
        return self._role_maker.get_pserver_endpoints()

    @property
    def main_program(self):
        """The program to run after ``minimize``: in the collective mode a
        ``CompiledProgram`` in data parallelism over the mesh; in PS mode
        the trainer program, which sends grads and receives
        parameters."""
        return self._compiled

    @property
    def startup_program(self):
        from paddle_tpu_torch import framework

        if self._ps_startup is not None:
            return self._ps_startup
        return framework.default_startup_program()

    # -- PS-mode control plane --------------------------------------------
    def init_worker(self):
        pass

    def init_server(self, model_dir=None, place=None):
        """PS mode: run this server's startup program in the global
        scope (reference fleet.init_server); with ``model_dir``, warm
        start every var of the server program from the ``<name>.npy``
        shard files a ``checkpoint_notify`` to that directory wrote."""
        if self._transpiler is None:
            return
        from paddle_tpu_torch.core.executor import Executor
        from paddle_tpu_torch.core.scope import global_scope
        from paddle_tpu_torch.core.types import from_numpy

        t = self._transpiler
        ep = self._role_maker.get_current_endpoint()
        self._ps_main = t.get_pserver_program(ep)
        exe = Executor(place)
        exe.run(t.get_startup_program(ep, self._ps_main))
        if not model_dir:
            return
        loaded = 0
        for v in self._ps_main.global_block().vars.values():
            path = os.path.join(model_dir, v.name.replace("/", "_") + ".npy")
            if os.path.exists(path):
                global_scope().var(v.name).set(
                    from_numpy(np.load(path), v.name).to(exe.device))
                loaded += 1
        if not loaded:
            raise FileNotFoundError(
                f"init_server: no shard files found in {model_dir}")

    def run_server(self, place=None):
        """PS mode: serve until every trainer completes (reference
        fleet.run_server -> the listen_and_serv loop)."""
        if self._transpiler is None:
            raise RuntimeError(
                "run_server needs a PS-mode distributed_optimizer "
                "(strategy.mode='pserver') minimized first")
        from paddle_tpu_torch.core.executor import Executor

        if self._ps_main is None:
            self._ps_main = self._transpiler.get_pserver_program(
                self._role_maker.get_current_endpoint())
        Executor(place).run(self._ps_main)

    def stop_worker(self):
        pass

    def barrier_worker(self):
        """A barrier across the workers of a collective job (the data
        axis's group, else the world); one process is its own barrier."""
        from paddle_tpu_torch.parallel import env as penv

        mesh = penv.get_mesh()
        group = None
        if mesh is not None:
            group = mesh.group("dp" if "dp" in mesh.axis_names
                               else mesh.axis_names[0])
        penv.barrier(group)

    # -- optimizer --------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        explicit = strategy is not None
        self._strategy = strategy or DistributedStrategy()
        if self._strategy.mode == "pserver" or (
                not explicit
                and self._role_maker is not None
                and self._role_maker.get_pserver_endpoints()):
            self._strategy.mode = "pserver"
            return ParameterServerOptimizer(self, optimizer,
                                            self._strategy)
        return CollectiveOptimizer(self, optimizer, self._strategy)

    # -- save (reference fleet_base save_* delegating to io) --------------
    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from paddle_tpu_torch import framework, io

        return io.save_inference_model(
            dirname, feeded_var_names, target_vars, executor,
            main_program or self._origin_program
            or framework.default_main_program())


class CollectiveOptimizer:
    """reference incubate/fleet/collective/__init__.py:215: ``minimize``
    builds the program with the wrapped optimizer (under AMP with
    ``strategy.use_amp``) and makes fleet's ``main_program`` a
    ``CompiledProgram`` in data parallelism over the mesh (a 1-D 'dp'
    mesh over the world unless one is set), with ZeRO's rules at
    ``strategy.zero_stage``."""

    def __init__(self, fleet_obj, optimizer, strategy):
        self._fleet = fleet_obj
        self._optimizer = optimizer
        self._strategy = strategy

    def backward(self, *a, **k):
        return self._optimizer.backward(*a, **k)

    def apply_gradients(self, *a, **k):
        return self._optimizer.apply_gradients(*a, **k)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from paddle_tpu_torch.core.compiler import CompiledProgram
        from paddle_tpu_torch.parallel import env as penv
        from paddle_tpu_torch.parallel.zero import zero_sharding_rules

        opt = self._optimizer
        if self._strategy.use_amp:
            from paddle_tpu_torch.contrib import mixed_precision as amp

            opt = amp.decorate(
                opt, init_loss_scaling=self._strategy.amp_loss_scaling)
        ret = opt.minimize(loss, startup_program, parameter_list,
                           no_grad_set)
        main = loss.block.program
        self._fleet._origin_program = main
        if penv.get_mesh() is None:
            penv.set_mesh(penv.make_mesh())
        compiled = CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=penv.get_mesh())
        if self._strategy.zero_stage:
            compiled = compiled.with_sharding_rules(
                zero_sharding_rules(stage=self._strategy.zero_stage,
                                    program=main))
        self._fleet._compiled = compiled
        return ret


class ParameterServerOptimizer:
    """PS-mode distributed optimizer: minimize() transpiles the program
    with DistributeTranspiler (reference
    incubate/fleet/parameter_server/distribute_transpiler/__init__.py
    TranspilerOptimizer)."""

    def __init__(self, fleet_obj, optimizer, strategy):
        self._fleet = fleet_obj
        self._optimizer = optimizer
        self._strategy = strategy

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from paddle_tpu_torch.transpiler import (DistributeTranspiler,
                                                 DistributeTranspilerConfig)

        ret = self._optimizer.minimize(loss, startup_program,
                                       parameter_list, no_grad_set)
        rm = self._fleet._role_maker
        cfg = DistributeTranspilerConfig()
        cfg.sync_mode = self._strategy.sync_mode
        t = DistributeTranspiler(cfg)
        t.transpile(rm.worker_index(),
                    program=loss.block.program,
                    startup_program=startup_program,
                    pservers=",".join(rm.get_pserver_endpoints()),
                    trainers=rm.worker_num(),
                    sync_mode=self._strategy.sync_mode)
        self._fleet._transpiler = t
        self._fleet._origin_program = loss.block.program
        if rm.is_worker():
            self._fleet._compiled = t.get_trainer_program()
            self._fleet._ps_startup = t.get_trainer_startup_program()
        return ret


fleet = _Fleet()
