"""Downpour SGD distributed optimizer (the pre-fleet pslib CTR path).

Counterpart of ``paddle_tpu/distributed/downpour.py``: ``minimize``
finds the distributed lookup table, appends the backward and records
the sparse/dense table plan on ``program._fleet_opt``, which the
TrainerFactory / DownpourSGD device worker (``device_worker.py``) and
the parameter-server transpiler consume; it returns ``(opt_info,
worker_skipped_ops)``, shaped like the reference's ``(ps_param,
worker_skipped_ops)``.  As in the JAX package, a program whose
distributed lookups read more than one table (DeepFM's two) is refused.

Reference parity: python/paddle/fluid/distributed/downpour.py:24
DownpourSGD (the reference emits pslib protobuf table configs for
Baidu's closed parameter server).
"""

from __future__ import annotations

__all__ = ["DownpourSGD"]

# data_norm accumulators ride the DENSE table (reference downpour.py:49)
_DATA_NORM_SUFFIXES = (
    ".batch_size", ".batch_square_sum", ".batch_sum",
    ".batch_size@GRAD", ".batch_square_sum@GRAD", ".batch_sum@GRAD")


def _find_distributed_lookup_table(program):
    """Name of the is_distributed lookup table param, or None (reference
    distributed/helper.py find_distributed_lookup_table)."""
    table = None
    for op in program.global_block().ops:
        if op.type == "lookup_table" and op.attrs.get("is_distributed"):
            w = op.inputs["W"][0]
            if table is not None and table != w:
                raise ValueError(
                    "all distributed lookup_table ops must share one "
                    "table")
            table = w
    return table


def _table_io(program, table_name):
    """(input id slots, output emb slots) of the table's lookup ops."""
    ids, outs = [], []
    for op in program.global_block().ops:
        if op.type == "lookup_table" and op.inputs["W"][0] == table_name:
            ids.extend(op.inputs["Ids"])
            outs.extend(op.outputs["Out"])
    return ids, outs


class DownpourSGD:
    """reference downpour.py:24."""

    def __init__(self, learning_rate=0.001, window=1):
        self.learning_rate_ = learning_rate
        self.window_ = window
        self.type = "downpour"
        self.data_norm_name = list(_DATA_NORM_SUFFIXES)

    def minimize(self, losses, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Append backward for every loss and publish the downpour plan
        on each program's _fleet_opt (reference downpour.py:54)."""
        from paddle_tpu_torch.backward import append_backward

        if not isinstance(losses, list):
            raise ValueError("losses is a list, just like [model.cost]")

        program = losses[0].block.program
        table_name = _find_distributed_lookup_table(program)
        prefetch_slots, prefetch_slots_emb = ([], [])
        if table_name is not None:
            prefetch_slots, prefetch_slots_emb = _table_io(
                program, table_name)

        dense_params, data_norm_params = [], []
        for loss in losses:
            params_grads = sorted(
                append_backward(loss, parameter_list, no_grad_set),
                key=lambda x: x[0].name)
            for p, g in params_grads:
                if p.name == table_name:
                    continue  # sparse table rides the sparse path
                if any(p.name.endswith(s) for s in self.data_norm_name):
                    data_norm_params.append(p.name)
                else:
                    dense_params.append(p.name)

        worker_skipped_ops = ["lookup_table", "lookup_table_grad"]
        opt_info = {
            "trainer": "DistMultiTrainer",
            "device_worker": "DownpourSGD",
            "optimizer": "DownpourSGD",
            "learning_rate": self.learning_rate_,
            "window": self.window_,
            "sparse_tables": [table_name] if table_name else [],
            "sparse_table_slots": prefetch_slots,
            "sparse_table_embs": prefetch_slots_emb,
            "dense_tables": sorted(set(dense_params)),
            "data_norm_tables": sorted(set(data_norm_params)),
            "skip_ops": worker_skipped_ops,
        }
        for loss in losses:
            loss.block.program._fleet_opt = opt_info
        return [opt_info, worker_skipped_ops]
