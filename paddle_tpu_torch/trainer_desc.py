"""Trainer descriptors for the dataset-driven training path.

Counterpart of ``paddle_tpu/trainer_desc.py``: the same classes, fields
and ``_desc()`` text.  The reference serializes these into a TrainerDesc
protobuf consumed by the C++ trainer factory; here the descriptor is a
plain config object consumed by ``Executor.train_from_dataset``
(``core/executor.py``).

Reference parity: python/paddle/fluid/trainer_desc.py:21 TrainerDesc +
trainer_factory.py, backing framework/trainer.h:38 MultiTrainer /
DistMultiTrainer / PipelineTrainer.
"""

from __future__ import annotations

__all__ = ["TrainerDesc", "MultiTrainer", "DistMultiTrainer",
           "PipelineTrainer", "TrainerFactory"]


class TrainerDesc:
    """reference trainer_desc.py:21 — accumulates the training-loop config
    (fetch vars, debug period, thread count, device worker)."""

    def __init__(self):
        self._fetch_vars = []
        self._fetch_info = []
        self._print_period = 100
        self._debug = False
        self._thread_num = 1
        self._infer = False
        self._fleet_desc = None
        self._device_worker = None
        self._program = None
        self.class_name = self.__class__.__name__

    def _set_fetch_var_and_info(self, fetch_vars, fetch_info, print_period):
        self._fetch_vars = list(fetch_vars or [])
        self._fetch_info = list(fetch_info or [])
        self._print_period = print_period

    def _set_debug(self, debug):
        self._debug = bool(debug)

    def _set_thread(self, thread_num):
        self._thread_num = max(1, int(thread_num))

    def _set_device_worker(self, device_worker):
        self._device_worker = device_worker

    def _set_infer(self, infer):
        self._infer = bool(infer)

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _set_program(self, program):
        self._program = program
        if self._device_worker is not None:
            self._device_worker._set_program(program)

    def _gen_trainer_desc(self):
        if self._device_worker is not None:
            self._device_worker._set_infer(self._infer)
            self._device_worker._gen_worker_desc(self)

    def _desc(self):
        """Debug text form (the reference returns protobuf text)."""
        worker = getattr(self, "device_worker_name", None)
        return (f"class_name: {self.class_name}\n"
                f"device_worker_name: {worker}\n"
                f"thread_num: {self._thread_num}\n"
                f"debug: {self._debug}\n"
                f"fetch_info: {self._fetch_info}\n"
                f"print_period: {self._print_period}\n")

    def __str__(self):
        return self._desc()


class MultiTrainer(TrainerDesc):
    """Local dataset trainer (reference trainer_desc.py:82 →
    framework/trainer.h:63 MultiTrainer)."""

    def _gen_trainer_desc(self):
        super()._gen_trainer_desc()
        self.trainer_name = "MultiTrainer"


class DistMultiTrainer(TrainerDesc):
    """PS/Downpour dataset trainer (reference trainer_desc.py:98 →
    framework/trainer.h:81)."""

    def _gen_trainer_desc(self):
        super()._gen_trainer_desc()
        self.trainer_name = "DistMultiTrainer"


class PipelineTrainer(TrainerDesc):
    """Pipeline-section trainer (reference trainer_desc.py:117 →
    framework/trainer.h:95)."""

    def _gen_trainer_desc(self):
        super()._gen_trainer_desc()
        self.trainer_name = "PipelineTrainer"


class TrainerFactory:
    """reference trainer_factory.py:26 — pick trainer + device worker from
    `program._fleet_opt` (or defaults: MultiTrainer + Hogwild)."""

    def _create_trainer(self, opt_info=None):
        from paddle_tpu_torch.device_worker import DeviceWorkerFactory

        if not opt_info:
            trainer = MultiTrainer()
            worker = DeviceWorkerFactory()._create_device_worker("Hogwild")
        else:
            trainer_name = opt_info.get("trainer", "MultiTrainer")
            worker_name = opt_info.get("device_worker", "Hogwild")
            trainer = globals()[trainer_name]()
            worker = DeviceWorkerFactory()._create_device_worker(worker_name)
            worker._set_fleet_desc(opt_info.get("fleet_desc"))
            trainer._set_fleet_desc(opt_info.get("fleet_desc"))
        trainer._set_device_worker(worker)
        return trainer
