"""Async, optimizer-state-aware checkpointing.

Counterpart of ``paddle_tpu/contrib/checkpoint/__init__.py``, with the
same API and resume contract, in a format of the port's own (the JAX
package writes orbax checkpoints, which this package does not read;
neither reads the other's, ROADMAP Queue 3):

  - ``save(step)`` takes a host snapshot of the scope's persistable
    state (params and every optimizer accumulator: exactly the set a
    resume needs) on the caller's thread, then returns; a writer thread
    writes one ``.npy`` file a var and a ``MANIFEST.json`` into
    ``<dir>/step_<step>.tmp`` and renames it to ``<dir>/step_<step>``,
    so a step directory is whole or absent;
  - ``latest_step()`` sees committed steps only;
  - ``restore(step)`` refuses a checkpoint holding state the scope
    lacks, and sets each var as a fresh tensor on the device its
    current value lives on;
  - ``max_to_keep`` keeps the newest committed steps.

    ck = AsyncCheckpointer("/ckpts")
    ck.save(step, program=main)           # returns after the snapshot
    ...
    ck.wait()                             # barrier before exit
    ck.restore(step, program=main)        # into the scope
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading

import numpy as np
import torch

__all__ = ["AsyncCheckpointer"]

_STEP_DIR = re.compile(r"^step_(\d+)$")
_MANIFEST = "MANIFEST.json"


class AsyncCheckpointer:
    def __init__(self, dirname, max_to_keep=None):
        self._dir = os.path.abspath(dirname)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._jobs: queue.Queue = queue.Queue()
        self._errors = []
        self._writer = threading.Thread(target=self._write_loop,
                                        daemon=True)
        self._writer.start()

    # ------------------------------------------------------------ state
    def _state(self, program=None, scope=None):
        from paddle_tpu_torch import framework
        from paddle_tpu_torch.core.scope import global_scope

        program = program or framework.default_main_program()
        scope = scope or global_scope()
        state = {}
        for v in program.persistables():
            if getattr(v, "is_data", False):
                continue
            var = scope.find_var(v.name)
            if var is None or not isinstance(var.get(), torch.Tensor):
                continue  # tensor arrays etc. are not checkpoint state
            state[v.name] = var.get()
        return program, scope, state

    def _step_dir(self, step):
        return os.path.join(self._dir, f"step_{int(step)}")

    # ----------------------------------------------------------- writer
    def _write_loop(self):
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                self._write(*job)
            except BaseException as e:  # noqa: BLE001 (raised by wait)
                self._errors.append(e)
            finally:
                self._jobs.task_done()

    def _write(self, step, snapshot):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {}
        for i, (name, arr) in enumerate(sorted(snapshot.items())):
            fname = f"{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[fname] = name
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"step": int(step), "vars": manifest}, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self._max_to_keep:
            for old in self._steps()[:-int(self._max_to_keep)]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _steps(self):
        steps = []
        for name in os.listdir(self._dir):
            m = _STEP_DIR.match(name)
            if m and os.path.exists(os.path.join(self._dir, name,
                                                 _MANIFEST)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    # ------------------------------------------------------------- API
    def save(self, step, program=None, scope=None):
        """Snapshot the persistable state to the host and return; the
        files are written and committed in the background.  Returns the
        names saved."""
        from paddle_tpu_torch.core.types import to_numpy

        _, _, state = self._state(program, scope)
        snapshot = {n: to_numpy(t, n, pinned=False)
                    for n, t in state.items()}
        self._jobs.put((int(step), snapshot))
        return sorted(state)

    def wait(self):
        """Block until every outstanding save has committed; raises the
        first error a write hit."""
        self._jobs.join()
        if self._errors:
            err, self._errors = self._errors[0], []
            raise RuntimeError(f"checkpoint write failed: {err}") from err

    def latest_step(self):
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step=None, program=None, scope=None):
        """Load a checkpoint into the scope (params AND optimizer
        accumulators — training resumes exactly).  The scope must hold
        initialized persistables (run the startup program first): a
        checkpoint holding state the scope lacks raises instead of
        silently resuming from partial state."""
        from paddle_tpu_torch.core.types import from_numpy

        program, scope, state = self._state(program, scope)
        step = int(step) if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        if not state:
            raise RuntimeError(
                "restore: no initialized persistables in the scope — "
                "run the startup program before restoring")
        path = self._step_dir(step)
        with open(os.path.join(path, _MANIFEST)) as f:
            stored = json.load(f)["vars"]
        missing = sorted(set(stored.values()) - set(state))
        if missing:
            raise RuntimeError(
                "restore: checkpoint contains state absent from the "
                f"current scope/program: {missing[:8]}"
                f"{'...' if len(missing) > 8 else ''}")
        for fname, name in stored.items():
            cur = state[name]
            val = from_numpy(np.load(os.path.join(path, fname)), name)
            scope.var(name).set(val.to(cur.device, dtype=cur.dtype))
        return sorted(stored.values())

    def close(self):
        self.wait()
        self._jobs.put(None)
        self._writer.join()
