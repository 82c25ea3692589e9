"""Dataset API: file-list driven training data (MultiSlot format).

Counterpart of ``paddle_tpu/dataset.py``: the same parse and batching,
so the same files give the same batches in both packages.  Reader
threads read and parse on the host (the native C++ parser and blocking
queue of ``native/``); batches stay numpy until ``DeviceFeeder``
(``reader.py``) puts them on the card ahead of the executor.

Reference parity:
  - DatasetFactory / InMemoryDataset / QueueDataset:
    python/paddle/fluid/dataset.py:21,224,487
  - the C++ DataFeed/DatasetImpl they wrap:
    paddle/fluid/framework/data_feed.h:475 (MultiSlot text parser),
    data_set.h:110 (in-memory store + shuffle), data_feed.proto
  - consumed by Executor.train_from_dataset (executor.py:927 ->
    framework/executor.cc:120 RunFromDataset -> trainer/DeviceWorker).
"""

from __future__ import annotations

import os
import threading

import numpy as np

from paddle_tpu_torch import native


def _slot_type(var):
    if var.dtype is not None and "int" in str(var.dtype):
        return "int64"
    return "float"


class DatasetBase:
    """reference dataset.py DatasetBase."""

    def __init__(self):
        self._batch_size = 1
        self._thread = 1
        self._filelist = []
        self._pipe_command = None
        self._use_vars = []
        self._parser = None

    # -- config (reference setter API) ------------------------------------
    def set_batch_size(self, batch_size):
        self._batch_size = batch_size

    def set_thread(self, thread_num):
        self._thread = max(1, int(thread_num))

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_pipe_command(self, pipe_command):
        """Each file is piped through this shell command before parsing
        (reference Dataset pipe_command preprocessing).  Not applicable
        to .recordio files (binary records): mixing the two raises at
        read time."""
        self._pipe_command = pipe_command

    def set_use_var(self, var_list):
        self._use_vars = list(var_list)
        self._parser = native.MultiSlotParser(
            [_slot_type(v) for v in var_list])

    def set_hdfs_config(self, fs_name, fs_ugi):  # capability stub
        pass

    # -- reading ----------------------------------------------------------
    def _read_file(self, path):
        if self._pipe_command:
            return native.ShellReader(
                f"cat {path} | {self._pipe_command}").read_all()
        with open(path, "rb") as f:
            return f.read()

    def _read_file_tagged(self, path):
        """b"T" + file bytes without an extra full-size copy (readinto a
        pre-tagged buffer) for the plain-file path."""
        if self._pipe_command:
            return b"T" + self._read_file(path)
        size = os.path.getsize(path)
        buf = bytearray(1 + size)
        buf[0] = ord("T")
        with open(path, "rb") as f:
            f.readinto(memoryview(buf)[1:])
        return bytes(buf)

    def _parse_file(self, path):
        """-> list of per-sample tuples of np arrays (one per slot).

        .recordio files (recordio_writer.py convert_reader_to_recordio_*)
        hold wire-codec batch dicts; anything else is MultiSlot text."""
        if path.endswith(".recordio"):
            if self._pipe_command:
                raise ValueError(
                    "pipe_command cannot be applied to binary .recordio "
                    "files (set_pipe_command is for text inputs)")
            samples = []
            from paddle_tpu_torch.recordio_writer import read_recordio_file

            for rec in read_recordio_file(path):
                samples.extend(self._record_to_samples(rec))
            return samples
        n, slots = self._parser.parse(self._read_file(path))
        samples = []
        for i in range(n):
            sample = []
            for vals, lod in slots:
                sample.append(vals[lod[i]:lod[i + 1]])
            samples.append(tuple(sample))
        return samples

    def _record_to_samples(self, rec):
        """One recordio batch dict -> per-sample tuples in use_var order."""
        cols = [np.asarray(rec[v.name]) for v in self._use_vars]
        batch = cols[0].shape[0]
        return [tuple(c[i] for c in cols) for i in range(batch)]

    def _batch_to_feed(self, batch):
        """batch: list of sample tuples -> {var_name: ndarray} with
        uniform slots reshaped to the var's shape and ragged slots
        zero-padded to the batch max (segment padding replaces LoD,
        SURVEY.md §7 hard part (a))."""
        feed = {}
        for si, var in enumerate(self._use_vars):
            vals = [s[si] for s in batch]
            lens = {len(v) for v in vals}
            if len(lens) == 1:
                arr = np.stack(vals)
                if var.shape is not None and len(var.shape) > 1:
                    want = [len(batch)] + [int(d) for d in var.shape[1:]]
                    if np.prod(want) == arr.size:
                        arr = arr.reshape(want)
            else:
                maxlen = max(lens)
                arr = np.zeros((len(batch), maxlen), vals[0].dtype)
                for i, v in enumerate(vals):
                    arr[i, :len(v)] = v
                if var.shape is not None and len(var.shape) >= 2 \
                        and var.shape[-1] == 1:
                    arr = arr[..., None]
            feed[var.name] = arr
        return feed

    def _iter_batches(self):
        raise NotImplementedError


class QueueDataset(DatasetBase):
    """Streaming dataset: reader threads push raw file bytes into the
    native blocking queue; the main loop parses and batches (reference
    dataset.py:487 QueueDataset / MultiSlotDataFeed streaming)."""

    def _iter_batches(self):
        if not self._use_vars:
            raise RuntimeError("call set_use_var first")
        q = native.BlockingQueue(capacity=max(2, self._thread * 2))
        files = list(self._filelist)

        def reader(paths):
            try:
                for p in paths:
                    if p.endswith(".recordio"):
                        if self._pipe_command:
                            raise ValueError(
                                "pipe_command cannot be applied to "
                                "binary .recordio files")
                        # records are already wire-encoded batch dicts
                        scanner = native.RecordIOScanner(p)
                        try:
                            for rec in scanner:
                                if not q.push(b"R" + rec):
                                    return
                        finally:
                            scanner.close()
                        continue
                    if not q.push(self._read_file_tagged(p)):
                        return
            except Exception as e:  # surface to the consumer, not silence
                q.push(b"E" + repr(e).encode("utf-8", "replace"))

        threads = []
        for t in range(self._thread):
            chunk = files[t::self._thread]
            th = threading.Thread(target=reader, args=(chunk,),
                                  daemon=True)
            th.start()
            threads.append(th)

        def closer():
            for th in threads:
                th.join()
            q.close()

        threading.Thread(target=closer, daemon=True).start()

        from paddle_tpu_torch.distributed.rpc import wire_loads

        try:
            yield from self._consume(q, wire_loads)
        finally:
            # unblock any reader still in q.push (error paths / early
            # generator abandonment): push returns False once closed
            q.close()

    def _consume(self, q, wire_loads):
        pending = []
        while True:
            data = q.pop()
            if data is None:
                break
            if data[:1] == b"E":
                raise RuntimeError(
                    "dataset reader thread failed: "
                    + data[1:].decode("utf-8", "replace"))
            if data[:1] == b"R":
                new_samples = self._record_to_samples(wire_loads(data[1:]))
            else:
                n, slots = self._parser.parse(data[1:])
                new_samples = [
                    tuple(vals[lod[i]:lod[i + 1]] for vals, lod in slots)
                    for i in range(n)]
            for sample in new_samples:
                pending.append(sample)
                if len(pending) == self._batch_size:
                    yield self._batch_to_feed(pending)
                    pending = []
        if pending:
            yield self._batch_to_feed(pending)


class InMemoryDataset(DatasetBase):
    """reference dataset.py:224 InMemoryDataset: load all samples, shuffle
    in memory, then train."""

    def __init__(self):
        super().__init__()
        self._samples = []

    def load_into_memory(self):
        self._samples = []
        for path in self._filelist:
            self._samples.extend(self._parse_file(path))

    def local_shuffle(self, seed=0):
        rng = np.random.RandomState(seed)
        rng.shuffle(self._samples)

    def global_shuffle(self, fleet=None, seed=0):
        """One process holds the whole sample pool, so global shuffle
        is local shuffle (the reference shuffles across trainer
        processes here), as in the JAX package."""
        self.local_shuffle(seed)

    def release_memory(self):
        self._samples = []

    def get_memory_data_size(self, fleet=None):
        return len(self._samples)

    def _iter_batches(self):
        if not self._use_vars:
            raise RuntimeError("call set_use_var first")
        for i in range(0, len(self._samples), self._batch_size):
            yield self._batch_to_feed(self._samples[i:i + self._batch_size])


class DatasetFactory:
    """reference dataset.py:21."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        raise ValueError(f"unknown dataset class {datafeed_class}")
