"""Device-worker descriptors.

Counterpart of ``paddle_tpu/device_worker.py``: the same classes and the
same fields they write on a trainer descriptor, which carries the loop
policy into ``Executor.train_from_dataset``:

- Hogwild     -> the local loop over the dataset, through DeviceFeeder.
- DownpourSGD -> the Downpour loop of ``distributed/downpour_worker.py``
                 (sparse pull, forward and backward, async push).
- Section     -> describes a pipeline section plan
                 (``program._pipeline_opt``); the pipeline runner is not
                 ported (ROADMAP Queue 1 item 5).

Reference parity: python/paddle/fluid/device_worker.py:18 DeviceWorker /
Hogwild / DownpourSGD / Section + DeviceWorkerFactory, backing
framework/device_worker.h:50 and hogwild_worker.cc / downpour_worker.cc /
section_worker.cc.
"""

from __future__ import annotations

__all__ = ["DeviceWorker", "Hogwild", "DownpourSGD", "Section",
           "DeviceWorkerFactory"]


class DeviceWorker:
    """reference device_worker.py:18."""

    def __init__(self):
        self._program = None
        self._infer = False
        self._fleet_desc = None

    def _set_infer(self, infer=False):
        self._infer = bool(infer)

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _set_program(self, program):
        self._program = program

    def _gen_worker_desc(self, trainer_desc):
        raise NotImplementedError(
            "DeviceWorker should use an implementation like "
            "Hogwild/DownpourSGD/Section")


class Hogwild(DeviceWorker):
    """Lock-free local worker (reference device_worker.py:71,
    hogwild_worker.cc:137 TrainFiles)."""

    def _gen_worker_desc(self, trainer_desc):
        trainer_desc.device_worker_name = "HogwildWorker"
        # the reference skips feed ops when inferring; the executor feeds
        # by name so there is nothing to skip, but the field stays
        trainer_desc.skip_ops = ["feed"] if self._infer else []


class DownpourSGD(DeviceWorker):
    """Sparse-PS worker (reference device_worker.py:96,
    downpour_worker.cc:369): collects the sparse/dense table config from
    program._fleet_opt so the trainer knows which vars ride the PS."""

    def _gen_worker_desc(self, trainer_desc):
        trainer_desc.device_worker_name = "DownpourWorker"
        if self._program is None:
            raise RuntimeError(
                "program of current device worker is not configured")
        opt_info = getattr(self._program, "_fleet_opt", None) or {}
        trainer_desc.sparse_tables = list(opt_info.get("sparse_tables", []))
        trainer_desc.dense_tables = list(opt_info.get("dense_tables", []))
        trainer_desc.skip_ops = list(opt_info.get("skip_ops", []))


class Section(DeviceWorker):
    """Pipeline stage worker (reference device_worker.py:184,
    section_worker.cc:141): publishes the section plan recorded by
    PipelineOptimizer.minimize (program._pipeline_opt) on the trainer."""

    def _gen_worker_desc(self, trainer_desc):
        trainer_desc.device_worker_name = "SectionWorker"
        popt = getattr(self._program, "_pipeline_opt", None)
        if popt is None:
            raise RuntimeError(
                "Section worker needs PipelineOptimizer.minimize to have "
                "run on this program (no _pipeline_opt found)")
        trainer_desc.section_num = len(popt["sections"])
        trainer_desc.num_microbatches = popt.get("num_microbatches", 1)
        trainer_desc.queue_size = popt.get("queue_size",
                                           trainer_desc.num_microbatches)
        trainer_desc.start_cpu_core_id = popt.get("start_cpu_core_id", 0)


class DeviceWorkerFactory:
    """reference device_worker.py:236."""

    def _create_device_worker(self, worker_type):
        classes = {c.__name__: c for c in
                   (Hogwild, DownpourSGD, Section)}
        if worker_type not in classes:
            raise ValueError(f"unknown device worker type {worker_type!r}; "
                             f"choose from {sorted(classes)}")
        return classes[worker_type]()
