"""Collective transpilers: IR rewriters that make a local training
program collective-data-parallel.

Counterpart of ``paddle_tpu/transpiler/collective.py``: the same ops
appended at the same places, under the same ``checked_pass`` names, so a
program transpiled by either package ``to_dict``s equal.  The inserted
``c_allreduce_sum`` ops run over the ring's process group
(``ops/collective.py``) whenever it has more than one rank; on a ring of
one they are the identity, as in the JAX package.  LocalSGD averages
the parameters every ``k_steps`` steps.

Reference parity: python/paddle/fluid/transpiler/collective.py:36, 175,
263 (the loss scaling at :186, an all-reduce a gradient at :205).
"""

from __future__ import annotations

from paddle_tpu_torch.analysis.passes import checked_pass
from paddle_tpu_torch.core.program import BACKWARD, OPTIMIZE, OpDesc


class Collective:
    """reference collective.py:36."""

    def __init__(self, nrings=1):
        self.nrings = nrings

    @checked_pass("collective_transpile")
    def transpile(self, startup_program, main_program, rank, endpoints,
                  current_endpoint, wait_port=True):
        self.rank = rank
        ep_list = (endpoints.split(",") if isinstance(endpoints, str)
                   else list(endpoints))
        self.nranks = len(ep_list)
        # wait_port is accepted for the reference's API: nothing listens
        # on a peer trainer's endpoint (c_comm_init and c_gen_nccl_id do
        # nothing; the process group comes up from the PADDLE_* contract,
        # whose store waits for rank 0 itself)
        del wait_port
        self.startup_program = startup_program
        self.main_program = main_program
        self._transpile_startup_program()
        self._transpile_main_program()
        return self

    def _transpile_startup_program(self):
        gb = self.startup_program.global_block()
        gb.append_op(type="c_comm_init", inputs={}, outputs={},
                     attrs={"nranks": self.nranks, "rank": self.rank,
                            "ring_id": 0},
                     infer_shape=False)

    def _transpile_main_program(self):
        raise NotImplementedError


class GradAllReduce(Collective):
    """Insert loss scaling + allreduce per gradient (reference
    collective.py:175)."""

    def __init__(self, nrings=1):
        super().__init__(nrings)

    def _transpile_main_program(self):
        self._insert_scale_loss_grad_ops()
        self._insert_allreduce_ops()

    def _insert_scale_loss_grad_ops(self):
        """loss@GRAD /= nranks (reference :186) so the summed allreduce
        yields the mean gradient."""
        gb = self.main_program.global_block()
        for op in gb.ops:
            if op.type == "fill_constant" and op.outputs.get("Out") and \
                    op.outputs["Out"][0].endswith("@GRAD") and \
                    op.op_role == BACKWARD:
                op.attrs["value"] = float(op.attrs.get("value", 1.0)) / \
                    self.nranks
                break

    def _insert_allreduce_ops(self):
        gb = self.main_program.global_block()
        new_ops = []
        grad_names = set()
        for op in gb.ops:
            if op.op_role == OPTIMIZE and "Grad" in op.inputs:
                grad_names.add(op.inputs["Grad"][0])
        ring = 0
        for op in gb.ops:
            new_ops.append(op)
            for names in op.outputs.values():
                for n in names:
                    if n in grad_names and op.op_role == BACKWARD:
                        new_ops.append(OpDesc(
                            "c_allreduce_sum", {"X": [n]}, {"Out": [n]},
                            {"ring_id": ring % self.nrings,
                             "use_calc_stream": True}, BACKWARD))
                        ring += 1
                        grad_names.discard(n)
        gb.ops = new_ops


class LocalSGD(Collective):
    """Periodic parameter averaging (reference collective.py:263): train
    locally, every k steps allreduce-average the params."""

    STEP_VAR = "@LOCAL_SGD_STEP@"

    def __init__(self, nrings=1, k_steps=1):
        super().__init__(nrings)
        self.k_steps = k_steps

    def _transpile_startup_program(self):
        super()._transpile_startup_program()
        gb = self.startup_program.global_block()
        # int64: a float32 counter saturates (x+1==x) at 2^24 steps
        gb.create_var(self.STEP_VAR, shape=(1,), dtype="int64",
                      persistable=True)
        gb.append_op(type="fill_constant", inputs={},
                     outputs={"Out": self.STEP_VAR},
                     attrs={"shape": (1,), "dtype": "int64",
                            "value": 0},
                     infer_shape=False)

    def _transpile_main_program(self):
        """Every k steps: p <- mean_ranks(p).  The k-step schedule is a
        where()-select: the allreduce runs on every rank every step (the
        ranks' collectives must not diverge) and its result is applied
        only when step % k == 0."""
        gb = mb = self.main_program.global_block()
        params = [v.name for v in self.main_program.all_parameters()]
        scale = 1.0 / self.nranks
        step = self.STEP_VAR
        mb.create_var(step, shape=(1,), dtype="int64", persistable=True)
        gb.append_op(type="increment", inputs={"X": step},
                     outputs={"Out": step}, attrs={"step": 1.0},
                     op_role=OPTIMIZE, infer_shape=False)
        sync = "@LOCAL_SGD_SYNC@"
        mod = "@LOCAL_SGD_MOD@"
        kvar = "@LOCAL_SGD_K@"
        mb.create_var(sync, shape=(1,), dtype="bool")
        mb.create_var(mod, shape=(1,), dtype="int64")
        mb.create_var(kvar, shape=(1,), dtype="int64")
        gb.append_op(type="fill_constant", inputs={},
                     outputs={"Out": kvar},
                     attrs={"shape": (1,), "dtype": "int64",
                            "value": int(self.k_steps)},
                     op_role=OPTIMIZE, infer_shape=False)
        gb.append_op(type="elementwise_mod", inputs={"X": step, "Y": kvar},
                     outputs={"Out": mod}, op_role=OPTIMIZE,
                     infer_shape=False)
        zvar = "@LOCAL_SGD_ZERO@"
        mb.create_var(zvar, shape=(1,), dtype="int64")
        gb.append_op(type="fill_constant", inputs={},
                     outputs={"Out": zvar},
                     attrs={"shape": (1,), "dtype": "int64",
                            "value": 0},
                     op_role=OPTIMIZE, infer_shape=False)
        gb.append_op(type="equal", inputs={"X": mod, "Y": zvar},
                     outputs={"Out": sync}, op_role=OPTIMIZE,
                     infer_shape=False)
        for p in params:
            avg = f"{p}@LOCAL_SGD_AVG@"
            mb.create_var(avg, shape=mb.var(p).shape, dtype=mb.var(p).dtype)
            gb.append_op(type="c_allreduce_sum", inputs={"X": p},
                         outputs={"Out": avg},
                         attrs={"ring_id": 0, "use_calc_stream": True},
                         op_role=OPTIMIZE, infer_shape=False)
            gb.append_op(type="scale", inputs={"X": avg},
                         outputs={"Out": avg}, attrs={"scale": scale},
                         op_role=OPTIMIZE, infer_shape=False)
            gb.append_op(type="where", inputs={"Condition": sync, "X": avg,
                                               "Y": p},
                         outputs={"Out": p}, op_role=OPTIMIZE,
                         infer_shape=False)
