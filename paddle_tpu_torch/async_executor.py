"""AsyncExecutor — the legacy pre-Trainer CTR entry point.

Counterpart of ``paddle_tpu/async_executor.py``: its ``run`` is
``Executor.train_from_dataset`` over a ``QueueDataset`` built from the
same ``DataFeedDesc`` and file list; the parameter-server half of its
API forwards to fleet.  ``AsyncExecutor()`` with no place runs on
``CUDAPlace(0)``, as ``Executor()`` does (the JAX package's default is
the CPU).

Reference parity: framework/async_executor.h:62 AsyncExecutor::
RunFromFile + executor_thread_worker.cc:295 TrainFiles.
"""

from __future__ import annotations

__all__ = ["AsyncExecutor"]


class AsyncExecutor:
    def __init__(self, place=None, run_mode=""):
        from paddle_tpu_torch.core.executor import Executor

        self._exe = Executor(place)
        self.run_mode = run_mode

    def run(self, program, data_feed, filelist, thread_num,
            fetch_var_names=None, mode="", debug=False):
        """reference AsyncExecutor::RunFromFile: interpret `program`
        over the files in `filelist` as described by `data_feed` (a
        DataFeedDesc), `thread_num` reader threads."""
        from paddle_tpu_torch.dataset import DatasetFactory

        ds = DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(int(data_feed.batch_size()))
        ds.set_thread(thread_num)
        ds.set_filelist(filelist)
        pipe = data_feed.proto_desc.get("pipe_command")
        if pipe and pipe != "cat":
            ds.set_pipe_command(pipe)
        block = program.global_block()
        use_vars = [block.var(n) for n in data_feed.used_slots()
                    if block.has_var(n)]
        ds.set_use_var(use_vars)
        fetch = []
        for n in fetch_var_names or []:
            fetch.append(block.var(n) if isinstance(n, str) else n)
        return self._exe.train_from_dataset(
            program=program, dataset=ds, thread=thread_num,
            debug=debug, fetch_list=fetch)

    # PS bootstrap half of the legacy API: forwarded to fleet
    def config_distributed_nodes(self):
        from paddle_tpu_torch.fleet import fleet

        return fleet

    def stop(self):
        from paddle_tpu_torch.fleet import fleet

        fleet.stop_worker()
