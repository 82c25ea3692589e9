"""The host-to-device prefetcher of the dataset path.

Counterpart of ``paddle_tpu/reader.py``'s ``DeviceFeeder`` (the rest of
that module, the reader decorators, ``PyReader`` and ``DataLoader``, is
not ported: ROADMAP Queue 1 item 6).  It replaces the reference's
double-buffered reader (operators/reader/buffered_reader.cc).

Pipeline: reader threads (a python generator, or the native C++ queue
behind ``QueueDataset``) produce numpy batches; the transfer thread
pins each batch's arrays and copies them to the card with
``non_blocking`` copies on a side stream of its own, records an event
after the copies, and parks up to ``device_prefetch`` batches; the
consumer's stream waits on that event before the batch is handed out,
so the executor never reads a batch still in flight, and the copy
overlaps the previous step's compute.  On the CPU the batches become
tensors sharing the arrays' memory.
"""

from __future__ import annotations

from queue import Queue
from threading import Thread

import torch

from paddle_tpu_torch.core.types import CUDAPlace, from_numpy

__all__ = ["DeviceFeeder"]


class DeviceFeeder:
    """Async host-to-device prefetcher (reference buffered_reader.cc).

    Two daemon threads double-buffer the feed path:
      * producer: drains ``batch_iter`` into a bounded host queue;
      * transfer: pops a host batch and, with ``to_device``, copies it to
        ``place``'s device (the card unless a ``CPUPlace`` is given).

    Iterating yields feed dicts of tensors already on the device, ready
    on the consumer's current stream."""

    _END = object()

    def __init__(self, batch_iter, capacity=8, device_prefetch=2,
                 to_device=True, place=None):
        self._host_q: Queue = Queue(maxsize=max(2, capacity))
        self._dev_q: Queue = Queue(maxsize=max(1, device_prefetch))
        self._err = []
        self._stopped = False
        self._device = (place if place is not None
                        else CUDAPlace(0)).torch_device() \
            if to_device else None

        def producer():
            try:
                for item in batch_iter:
                    if self._stopped:
                        return
                    self._host_q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                self._err.append(e)
            finally:
                self._host_q.put(DeviceFeeder._END)

        def transfer():
            try:
                stream = torch.cuda.Stream(self._device) \
                    if self._on_card() else None
                while True:
                    item = self._host_q.get()
                    if item is DeviceFeeder._END or self._stopped:
                        break
                    if self._device is not None:
                        item = self._transfer(item, stream)
                    self._dev_q.put(item)
            except BaseException as e:
                self._err.append(e)
            finally:
                self._dev_q.put(DeviceFeeder._END)

        self._threads = [Thread(target=producer, daemon=True),
                         Thread(target=transfer, daemon=True)]
        for t in self._threads:
            t.start()

    def _on_card(self):
        return self._device is not None and self._device.type == "cuda"

    def _transfer(self, item, stream):
        """(the batch's tensors on the device, the event after their
        copies or None)."""
        if stream is None:
            return {k: from_numpy(v, k) for k, v in item.items()}, None
        with torch.cuda.stream(stream):
            out = {k: from_numpy(v, k).pin_memory().to(
                self._device, non_blocking=True) for k, v in item.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def __iter__(self):
        return self

    def __next__(self):
        item = self._dev_q.get()
        if item is DeviceFeeder._END:
            # stay drained: re-park the sentinel so another next() raises
            # again instead of blocking on the empty queue forever
            self._dev_q.put(DeviceFeeder._END)
            if self._err:
                raise self._err[0]
            raise StopIteration
        if self._device is None:
            return item
        feed, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            for t in feed.values():
                # the side stream allocated them: their memory returns to
                # its pool only once the consumer's work on them is done
                t.record_stream(consumer)
        return feed

    def stop(self):
        self._stopped = True
        # unblock the threads if they are parked on full/empty queues,
        # then re-park sentinels: the transfer thread may loop back to
        # host_q.get() after its put unblocks, and consumers may call
        # next() again — both must see END, not block forever
        for q in (self._host_q, self._dev_q):
            try:
                while True:
                    q.get_nowait()
            except Exception:
                pass
            try:
                q.put_nowait(DeviceFeeder._END)
            except Exception:
                pass
