"""DistributeTranspiler: rewrite a single-process training program into
trainer + pserver programs (parameter-server data parallelism).

Counterpart of ``paddle_tpu/transpiler/distribute_transpiler.py``: the
same plan, the same op and var names and attrs, so the four programs
(trainer, trainer startup, pserver, pserver startup) have a ``to_dict``
equal to the JAX package's for the same program, and a trainer of
either package runs against a pserver of the other.

Reference parity (distribute_transpiler.py): ``transpile`` :377,
``slice_variable`` :85, ``get_trainer_program`` :702,
``get_pserver_program`` :836 with the grad merge :1863,
``DistributeTranspilerConfig`` :131.

The transport is the socket control plane (``distributed/rpc.py``);
the grad merge is a mean on the pserver (one trainer's grad passes
through unchanged); the initial parameters come from trainer 0 pushing
its initialised params (the ``ps_sync_init`` op), so a PS run starts
from the local run's exact parameters.  The JAX package verifies the
IR around ``transpile`` and ``get_pserver_program`` (``checked_pass``);
the port has no such wrapper yet, as in its other transpilers.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.program import OPTIMIZE, OpDesc, Program
from paddle_tpu_torch.transpiler.ps_dispatcher import RoundRobin


class DistributeTranspilerConfig:
    """reference distribute_transpiler.py:131."""

    def __init__(self):
        self.slice_var_up = True
        self.split_method = RoundRobin
        self.min_block_size = 1024  # min rows*cols before slicing pays off
        self.sync_mode = True
        # liveness: trainers heartbeat the pservers; a trainer silent
        # for this long is declared dead and sync barriers re-count so
        # the survivors continue (see listen_and_serv effective_fanin)
        self.heartbeat_timeout = 10.0
        self.heartbeat_interval = 1.0
        # pserver barrier deadline: a wedged sync round raises a
        # diagnostic BarrierTimeoutError (naming barrier + waiters)
        # instead of hanging forever; 0.0 defers to the
        # PADDLE_TPU_BARRIER_TIMEOUT env (default 600s)
        self.barrier_timeout = 0.0
        # delay-compensated async SGD (reference
        # distribute_transpiler.py:1905 _append_dc_asgd_ops): corrects
        # each delayed grad with g + g*g*(w_now - w_at_pull) using a
        # per-trainer param backup snapshotted when the trainer pulls
        self.enable_dc_asgd = False


def slice_variable(shape, slice_count):
    """Split dim-0 of `shape` into up to slice_count contiguous sections
    (reference slice_variable :85, simplified to per-pserver sections).
    Returns [(start, end), ...]."""
    d0 = int(shape[0])
    n = min(slice_count, d0)
    bounds = np.linspace(0, d0, n + 1, dtype=np.int64)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n)
            if bounds[i + 1] > bounds[i]]


class DistributeTranspiler:
    """reference distribute_transpiler.py:183."""

    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()

    # ------------------------------------------------------------------ public
    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=None, startup_program=None):
        from paddle_tpu_torch import framework

        self.trainer_id = trainer_id
        self.trainers = trainers
        self.endpoints = [e for e in pservers.split(",") if e]
        self.sync_mode = (self.config.sync_mode if sync_mode is None
                          else sync_mode)
        self.origin_program = program or framework.default_main_program()
        self.origin_startup = (startup_program or
                               framework.default_startup_program())
        self._build_plan()
        self._build_trainer_program()
        self._build_trainer_startup()
        return self

    def get_trainer_program(self, wait_port=True):
        if wait_port and self.endpoints:
            # reference distribute_transpiler.py blocks on the pserver
            # ports here so a trainer never races its pservers into
            # connection-refused at startup
            from paddle_tpu_torch.transpiler.details import wait_server_ready

            wait_server_ready(self.endpoints)
        return self.trainer_program

    def get_trainer_startup_program(self):
        return self.trainer_startup

    def get_pserver_program(self, endpoint):
        return self._build_pserver_program(endpoint)

    def get_pserver_programs(self, endpoint):
        main = self._build_pserver_program(endpoint)
        return main, self.get_startup_program(endpoint, main)

    def get_startup_program(self, endpoint, pserver_program=None):
        return self._build_pserver_startup(endpoint)

    # ------------------------------------------------------------- planning
    def _build_plan(self):
        """Distribution plan: every optimized param (and its grad) maps to
        a list of sections [(ps_index, section_name, start, end)]."""
        gb = self.origin_program.global_block()
        # Only grad-consuming optimize ops move to pservers; Param-only
        # optimize ops (e.g. lookahead_update, which has no Grad input)
        # stay on the trainer — they operate on the post-recv params.
        self.opt_ops = [op for op in gb.ops
                        if op.op_role == OPTIMIZE and "Param" in op.inputs
                        and "Grad" in op.inputs]
        dispatcher = self.config.split_method(self.endpoints)
        self.param_plan = {}
        self.grad_of = {}
        self.lr_names = sorted({
            op.inputs["LearningRate"][0] for op in self.opt_ops
            if op.inputs.get("LearningRate")})
        n_ps = len(self.endpoints)
        self._plan_dist_tables(gb, n_ps)
        for op in self.opt_ops:
            pname = op.inputs["Param"][0]
            if pname in self.dist_tables:
                continue
            gname = op.inputs["Grad"][0]
            self.grad_of[pname] = gname
            var = gb.var(pname)
            shape = tuple(var.shape or ())
            numel = int(np.prod(shape)) if shape else 1
            if (self.config.slice_var_up and n_ps > 1 and shape
                    and shape[0] >= n_ps
                    and numel >= self.config.min_block_size):
                secs = slice_variable(shape, n_ps)
            else:
                secs = [(0, -1)]
            if len(secs) == 1:
                ep_i = self.endpoints.index(dispatcher.dispatch([var])[0])
                plan = [(ep_i, f"{pname}.block0", 0, -1)]
            else:
                plan = [(i, f"{pname}.block{i}", s, e)
                        for i, (s, e) in enumerate(secs)]
            self.param_plan[pname] = plan

    def _plan_dist_tables(self, gb, n_ps):
        """Distributed lookup tables (reference
        distribute_transpiler.py:1583 _replace_lookup_table_op_with_prefetch
        + lookup-table blocks on pservers): embedding params used by
        lookup_table ops with is_distributed=True never live on trainers —
        they shard row-wise across ALL pservers, forward becomes a
        prefetch RPC and backward a sparse (rows, values) push."""
        self.dist_tables = {}
        self.table_opt = {}
        for op in gb.ops:
            if op.type != "lookup_table" or \
                    not op.attrs.get("is_distributed"):
                continue
            wname = op.inputs["W"][0]
            if wname in self.dist_tables:
                raise NotImplementedError(
                    f"distributed table '{wname}' is consumed by more than"
                    " one lookup_table op — not supported yet")
            shape = tuple(gb.var(wname).shape)
            secs = slice_variable(shape, n_ps)
            self.dist_tables[wname] = [
                (i % n_ps, f"{wname}.block{i}", s, e)
                for i, (s, e) in enumerate(secs)]
            self.grad_of[wname] = wname + "@GRAD"
        for op in list(self.opt_ops):
            pname = op.inputs["Param"][0]
            if pname in self.dist_tables:
                if op.type != "sgd":
                    raise NotImplementedError(
                        "distributed lookup tables require the SGD"
                        f" optimizer (got '{op.type}'); reference parity:"
                        " sgd/adagrad only")
                self.table_opt[pname] = op
                self.opt_ops.remove(op)

    def _grad_section_name(self, pname, sec_name):
        return sec_name.replace(pname, self.grad_of[pname], 1) \
            if sec_name.startswith(pname) else sec_name + "@GRAD"

    # ------------------------------------------------------- trainer program
    def _build_trainer_program(self):
        prog = self.origin_program.clone()
        gb = prog.global_block()
        # Param-only optimize ops (lookahead_update etc.) stay on the
        # trainer but must run on the POST-recv params — pull them out
        # here and re-append after the recv/fetch_barrier below, else
        # recv would clobber their writes every step.
        trainer_opt_ops = [op for op in gb.ops
                           if op.op_role == OPTIMIZE
                           and "Param" in op.inputs
                           and "Grad" not in op.inputs]
        gb.ops = [op for op in gb.ops
                  if not (op.op_role == OPTIMIZE and "Param" in op.inputs)]
        eps = self.endpoints
        self._rewrite_dist_lookups(gb)
        # liveness: announce this trainer to every pserver's heartbeat
        # monitor (idempotent daemon; first exe.run starts it)
        gb.ops.insert(0, OpDesc(
            "heartbeat_start", {}, {},
            {"endpoints": list(eps),
             "peer_id": f"trainer{self.trainer_id}",
             "interval": float(self.config.heartbeat_interval)}))
        # send each grad's sections
        for pname, plan in self.param_plan.items():
            gname = self.grad_of[pname]
            gb.append_op(
                type="send", inputs={"X": gname}, outputs={},
                attrs={
                    "epmap": [eps[i] for i, *_ in plan],
                    "section_names": [
                        self._grad_section_name(pname, sec)
                        for _, sec, *_ in plan],
                    "sections": [[s, e] for _, _, s, e in plan],
                    "trainer_idx": int(self.trainer_id),
                }, infer_shape=False)
        # per-step learning-rate push for scheduler-produced lr vars
        for lr in self.lr_names:
            if not gb.var(lr).persistable:
                gb.append_op(
                    type="send", inputs={"X": lr}, outputs={},
                    attrs={"epmap": list(eps),
                           "section_names": [lr] * len(eps),
                           "sections": [[0, -1]] * len(eps)},
                    infer_shape=False)
        if self.sync_mode:
            gb.append_op(type="send_barrier", inputs={}, outputs={},
                         attrs={"endpoints": list(eps),
                                "peer_id": f"trainer{self.trainer_id}"},
                         infer_shape=False)
        # recv updated params
        self._append_recv_ops(gb)
        if self.sync_mode:
            gb.append_op(type="fetch_barrier", inputs={}, outputs={},
                         attrs={"endpoints": list(eps),
                                "peer_id": f"trainer{self.trainer_id}"},
                         infer_shape=False)
        gb.ops.extend(trainer_opt_ops)
        if self.dist_tables:
            # contrib.utils.lookup_table_utils reads this to convert the
            # prefetch program back to a local sparse-table one (reference
            # program._distributed_lookup_table)
            prog._distributed_lookup_table = next(iter(self.dist_tables))
        self.trainer_program = prog

    def _rewrite_dist_lookups(self, gb):
        """Swap distributed lookup_table fwd/bwd ops for prefetch /
        send_sparse_grad host ops (reference parameter_prefetch.cc +
        split_ids/merge_ids)."""
        if not self.dist_tables:
            return
        eps = self.endpoints
        new_ops = []
        for op in gb.ops:
            if op.type == "lookup_table" and \
                    op.inputs["W"][0] in self.dist_tables:
                wname = op.inputs["W"][0]
                plan = self.dist_tables[wname]
                emb_dim = int(self.origin_program.global_block()
                              .var(wname).shape[1])
                new_ops.append(OpDesc(
                    "prefetch", {"Ids": list(op.inputs["Ids"])},
                    {"Out": list(op.outputs["Out"])},
                    {"epmap": [eps[i] for i, *_ in plan],
                     "table_names": [sec for _, sec, *_ in plan],
                     "sections": [[s, e] for _, _, s, e in plan],
                     "padding_idx": int(op.attrs.get("padding_idx", -1)),
                     "emb_dim": emb_dim}, op.op_role))
            elif op.type == "lookup_table_grad" and \
                    op.inputs["W"][0] in self.dist_tables:
                wname = op.inputs["W"][0]
                plan = self.dist_tables[wname]
                new_ops.append(OpDesc(
                    "send_sparse_grad",
                    {"Ids": list(op.inputs["Ids"]),
                     "Grad": list(op.inputs["Out@GRAD"])}, {},
                    {"epmap": [eps[i] for i, *_ in plan],
                     "section_names": [
                         self._grad_section_name(wname, sec)
                         for _, sec, *_ in plan],
                     "sections": [[s, e] for _, _, s, e in plan],
                     "padding_idx": int(op.attrs.get("padding_idx", -1))},
                    op.op_role))
            else:
                new_ops.append(op)
        gb.ops = new_ops

    def _append_recv_ops(self, gb):
        for pname, plan in self.param_plan.items():
            gb.append_op(
                type="recv", inputs={}, outputs={"Out": pname},
                attrs={
                    "epmap": [self.endpoints[i] for i, *_ in plan],
                    "section_names": [sec for _, sec, *_ in plan],
                    "sections": [[s, e] for _, _, s, e in plan],
                    "trainer_idx": int(self.trainer_id),
                }, infer_shape=False)

    def _build_trainer_startup(self):
        prog = self.origin_startup.clone()
        gb = prog.global_block()
        if self.dist_tables and self.trainer_id != 0:
            # only the pusher (trainer 0) needs the full table on host to
            # seed the pserver shards; other trainers never touch it —
            # that's the point of is_distributed for 100k+-row tables
            gb.ops = [o for o in gb.ops
                      if not any(n in self.dist_tables
                                 for ns in o.outputs.values()
                                 for n in ns)]
        push_plan = []
        for pname, plan in list(self.param_plan.items()) + \
                list(self.dist_tables.items()):
            for i, sec, s, e in plan:
                push_plan.append([pname, self.endpoints[i], sec, s, e])
        gb.append_op(
            type="ps_sync_init",
            inputs={"X": list(self.param_plan) + list(self.dist_tables)},
            outputs={},
            attrs={"endpoints": list(self.endpoints),
                   "push_plan": push_plan if self.trainer_id == 0 else [],
                   "is_pusher": self.trainer_id == 0},
            infer_shape=False)
        # every trainer pulls the authoritative initial params
        self._append_recv_ops(gb)
        self.trainer_startup = prog

    # ------------------------------------------------------- pserver program
    def _sections_on(self, endpoint):
        ep_i = self.endpoints.index(endpoint)
        out = []
        for pname, plan in self.param_plan.items():
            for i, sec, s, e in plan:
                if i == ep_i:
                    out.append((pname, sec, s, e))
        return out

    def _sliced_shape(self, shape, s, e):
        shape = tuple(shape or ())
        if not shape or (s == 0 and e == -1):
            return shape
        return (e - s,) + shape[1:]

    def _build_pserver_program(self, endpoint):
        prog = Program()
        gb = prog.global_block()
        origin_gb = self.origin_program.global_block()
        dc = bool(self.config.enable_dc_asgd) and not self.sync_mode
        if dc:
            gb.create_var(name="@TRAINER_ID@", shape=(1,),
                          dtype="int64")
        grad_blocks = []
        dc_pairs = []
        for pname, sec, s, e in self._sections_on(endpoint):
            pvar = origin_gb.var(pname)
            shape = self._sliced_shape(pvar.shape, s, e)
            gb.create_var(name=sec, shape=shape, dtype=pvar.dtype,
                          persistable=True)
            gsec = self._grad_section_name(pname, sec)
            gb.create_var(name=gsec, shape=shape, dtype=pvar.dtype)
            opt_op = next(op for op in self.opt_ops
                          if op.inputs["Param"][0] == pname)
            sub = prog._create_block()
            opt_gsec = gsec
            if dc:
                opt_gsec = self._append_dc_asgd_ops(
                    gb, sub, sec, gsec, shape, pvar.dtype)
                dc_pairs.append([gsec, sec])
            self._clone_opt_op(prog, gb, sub, opt_op, pname, sec, gsec,
                               s, e, origin_gb, opt_gsec=opt_gsec)
            prog._rollback()
            grad_blocks.append([gsec, sub.idx])
        # distributed lookup-table shards + their sparse-update blocks
        sparse_grad_blocks = []
        ep_i = self.endpoints.index(endpoint)
        for wname, plan in self.dist_tables.items():
            wvar = origin_gb.var(wname)
            opt_op = self.table_opt[wname]
            lr_name = opt_op.inputs["LearningRate"][0]
            for i, sec, s, e in plan:
                if i != ep_i:
                    continue
                shape = self._sliced_shape(wvar.shape, s, e)
                gb.create_var(name=sec, shape=shape, dtype=wvar.dtype,
                              persistable=True)
                gsec = self._grad_section_name(wname, sec)
                sub = prog._create_block()
                sub.ops.append(OpDesc(
                    "sparse_sgd",
                    {"Param": [sec], "Rows": [gsec + ".rows"],
                     "Grad": [gsec + ".values"],
                     "LearningRate": [lr_name]},
                    {"ParamOut": [sec]}, {}, OPTIMIZE))
                prog._rollback()
                sparse_grad_blocks.append([gsec, sub.idx])
        for lr in self.lr_names:
            lv = origin_gb.var(lr)
            gb.create_var(name=lr, shape=lv.shape, dtype=lv.dtype,
                          persistable=True)
        gb.append_op(
            type="listen_and_serv", inputs={}, outputs={},
            attrs={"endpoint": endpoint, "Fanin": self.trainers,
                   "sync_mode": self.sync_mode,
                   "grad_blocks": grad_blocks,
                   "lr_names": list(self.lr_names),
                   "sparse_grad_blocks": sparse_grad_blocks,
                   "dc_pairs": dc_pairs,
                   "heartbeat_timeout":
                       float(self.config.heartbeat_timeout),
                   "barrier_timeout":
                       float(self.config.barrier_timeout)},
            infer_shape=False)
        return prog

    def _append_dc_asgd_ops(self, gb, sub, sec, gsec, shape, dtype):
        """Delay compensation on the pserver (reference
        distribute_transpiler.py:1905 _append_dc_asgd_ops):
        corrected = g + g*g*(w_now - w_bak[trainer]), where w_bak is
        the per-trainer snapshot taken when that trainer pulled w
        (request_handler_impl.cc RequestGetHandler dc_asgd branch).
        Returns the corrected grad var name the optimizer consumes."""
        bak_names = []
        for k in range(self.trainers):
            bn = f"{sec}.bak.{k}"
            gb.create_var(name=bn, shape=shape, dtype=dtype,
                          persistable=True)
            bak_names.append(bn)

        def tmp(suffix):
            name = f"{gsec}.{suffix}"
            sub.create_var(name=name, shape=shape, dtype=dtype)
            return name

        local_bak = tmp("local_bak")
        sub.ops.append(OpDesc(
            "ref_by_trainer_id",
            {"X": bak_names, "TrainerId": ["@TRAINER_ID@"]},
            {"Out": [local_bak]}, {}))
        o1, o2, o3, o4 = (tmp("dc1"), tmp("dc2"), tmp("dc3"),
                          tmp("dc"))
        sub.ops.append(OpDesc("elementwise_sub",
                              {"X": [sec], "Y": [local_bak]},
                              {"Out": [o1]}, {"axis": -1}))
        sub.ops.append(OpDesc("elementwise_mul",
                              {"X": [o1], "Y": [gsec]},
                              {"Out": [o2]}, {"axis": -1}))
        sub.ops.append(OpDesc("elementwise_mul",
                              {"X": [o2], "Y": [gsec]},
                              {"Out": [o3]}, {"axis": -1}))
        sub.ops.append(OpDesc("elementwise_add",
                              {"X": [gsec], "Y": [o3]},
                              {"Out": [o4]}, {"axis": -1}))
        return o4

    def _clone_opt_op(self, prog, gb, sub, opt_op, pname, sec, gsec,
                      s, e, origin_gb, opt_gsec=None):
        """Optimizer op remapped onto this param section: same-shaped
        accumulators are sliced alongside the param, scalar accumulators
        (beta pows) are copied per section (reference grad-merge +
        optimizer blocks, distribute_transpiler.py:1967).  opt_gsec
        overrides the Grad the optimizer consumes (DC-ASGD corrected
        grad) while gsec stays the wire/arrival name."""
        pshape = tuple(origin_gb.var(pname).shape or ())
        name_map = {pname: sec,
                    self.grad_of[pname]: opt_gsec or gsec}
        for slot, names in opt_op.inputs.items():
            for n in names:
                if n in name_map or n in self.lr_names:
                    continue
                v = origin_gb.var(n)
                vshape = tuple(v.shape or ())
                if vshape == pshape and vshape:
                    new = f"{n}.block_{sec.rsplit('.', 1)[-1]}"
                    gb.create_var(
                        name=new,
                        shape=self._sliced_shape(vshape, s, e),
                        dtype=v.dtype, persistable=True)
                else:
                    new = f"{n}.{sec.rsplit('.', 1)[-1]}"
                    gb.create_var(name=new, shape=vshape, dtype=v.dtype,
                                  persistable=True)
                name_map[n] = new
        ins = {slot: [name_map.get(n, n) for n in names]
               for slot, names in opt_op.inputs.items()}
        outs = {slot: [name_map.get(n, n) for n in names]
                for slot, names in opt_op.outputs.items()}
        sub.ops.append(OpDesc(opt_op.type, ins, outs, dict(opt_op.attrs),
                              OPTIMIZE))

    def _build_pserver_startup(self, endpoint):
        """Zeros for param sections (filled by the ps_sync_init push),
        cloned fill ops (with sliced shapes) for accumulators and lr."""
        prog = Program()
        gb = prog.global_block()
        origin_gb = self.origin_program.global_block()
        origin_sb = self.origin_startup.global_block()
        fills = {}
        for op in origin_sb.ops:
            if op.type == "fill_constant" and op.outputs.get("Out"):
                fills[op.outputs["Out"][0]] = op
        dc = bool(self.config.enable_dc_asgd) and not self.sync_mode
        for pname, sec, s, e in self._sections_on(endpoint):
            pvar = origin_gb.var(pname)
            shape = self._sliced_shape(pvar.shape, s, e)
            v = gb.create_var(name=sec, shape=shape, dtype=pvar.dtype,
                              persistable=True)
            gb.append_op(type="fill_constant", outputs={"Out": v},
                         attrs={"shape": list(shape), "dtype": pvar.dtype,
                                "value": 0.0}, infer_shape=False)
            if dc:
                # per-trainer DC-ASGD param backups start at zero; the
                # serve loop primes/snapshots them per trainer before
                # any correction selects them
                for k in range(self.trainers):
                    bv = gb.create_var(name=f"{sec}.bak.{k}",
                                       shape=shape, dtype=pvar.dtype,
                                       persistable=True)
                    gb.append_op(
                        type="fill_constant", outputs={"Out": bv},
                        attrs={"shape": list(shape),
                               "dtype": pvar.dtype, "value": 0.0},
                        infer_shape=False)
            # accumulators for this section
            opt_op = next(op for op in self.opt_ops
                          if op.inputs["Param"][0] == pname)
            pshape = tuple(pvar.shape or ())
            for slot, names in opt_op.inputs.items():
                for n in names:
                    if n in (pname, self.grad_of[pname]) or \
                            n in self.lr_names:
                        continue
                    ov = origin_gb.var(n)
                    vshape = tuple(ov.shape or ())
                    fill = fills.get(n)
                    value = float(fill.attrs.get("value", 0.0)) \
                        if fill is not None else 0.0
                    if vshape == pshape and vshape:
                        new = f"{n}.block_{sec.rsplit('.', 1)[-1]}"
                        nshape = self._sliced_shape(vshape, s, e)
                    else:
                        new = f"{n}.{sec.rsplit('.', 1)[-1]}"
                        nshape = vshape
                    nv = gb.create_var(name=new, shape=nshape,
                                       dtype=ov.dtype, persistable=True)
                    gb.append_op(
                        type="fill_constant", outputs={"Out": nv},
                        attrs={"shape": list(nshape), "dtype": ov.dtype,
                               "value": value}, infer_shape=False)
        ep_i = self.endpoints.index(endpoint)
        for wname, plan in self.dist_tables.items():
            wvar = origin_gb.var(wname)
            for i, sec, s, e in plan:
                if i != ep_i:
                    continue
                shape = self._sliced_shape(wvar.shape, s, e)
                nv = gb.create_var(name=sec, shape=shape,
                                   dtype=wvar.dtype, persistable=True)
                gb.append_op(
                    type="fill_constant", outputs={"Out": nv},
                    attrs={"shape": list(shape), "dtype": wvar.dtype,
                           "value": 0.0}, infer_shape=False)
        for lr in self.lr_names:
            lv = origin_gb.var(lr)
            fill = fills.get(lr)
            value = float(fill.attrs.get("value", 0.0)) if fill else 0.0
            nv = gb.create_var(name=lr, shape=lv.shape, dtype=lv.dtype,
                               persistable=True)
            gb.append_op(type="fill_constant", outputs={"Out": nv},
                         attrs={"shape": list(lv.shape or [1]),
                                "dtype": lv.dtype, "value": value},
                         infer_shape=False)
        return prog
