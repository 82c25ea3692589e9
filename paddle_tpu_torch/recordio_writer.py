"""Convert python readers into recordio files.

Counterpart of ``paddle_tpu/recordio_writer.py``: the same chunked
files and the same records, so a file written by either package reads
in the other.  ``feeder`` is any object with ``feed_vars`` and
``feed(batch) -> {name: array}`` (the JAX package's ``DataFeeder``
shape; ``data_feeder.py`` is not ported).

Reference parity: python/paddle/fluid/recordio_writer.py:26
create_recordio_writer / :34 convert_reader_to_recordio_file / :91
convert_reader_to_recordio_files, over paddle/fluid/recordio/
{writer,chunk}.h.

Records are written through the native chunked writer
(native/src/recordio.cc); each record is one batch's feed dict serialized
with the data-only RPC wire codec (distributed/rpc.py wire_dumps) —
tensors as dtype/shape/raw-bytes, no pickle.  `read_recordio_file` is the
matching reader the reference keeps in the recordio reader op.
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["create_recordio_writer", "convert_reader_to_recordio_file",
           "convert_reader_to_recordio_files", "read_recordio_file"]


@contextlib.contextmanager
def create_recordio_writer(filename, compressor=None,
                           max_num_records=1000):
    """Context manager over the native RecordIOWriter (reference :26).

    compressor and max_num_records are accepted for reference-signature
    parity but are no-ops: the native writer streams uncompressed host
    bytes with its own fixed chunking (native/src/recordio.cc)."""
    from paddle_tpu_torch import native

    writer = native.RecordIOWriter(filename)
    try:
        yield writer
    finally:
        writer.close()


def convert_reader_to_recordio_file(filename, reader_creator, feeder,
                                    compressor=None, max_num_records=1000,
                                    feed_order=None):
    """Write every batch of reader_creator() as one record; returns the
    record count (reference :34)."""
    from paddle_tpu_torch.distributed.rpc import wire_dumps

    if feed_order is None:
        feed_order = [v.name for v in feeder.feed_vars]
    counter = 0
    with create_recordio_writer(filename, compressor,
                                max_num_records) as writer:
        for batch in reader_creator():
            res = feeder.feed(batch)
            record = {name: res[name] for name in feed_order}
            writer.write(wire_dumps(record))
            counter += 1
    return counter


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder,
                                     compressor=None,
                                     max_num_records=1000,
                                     feed_order=None):
    """Shard the reader across many .recordio files of batch_per_file
    records each (reference :91).  Returns the total record count."""
    f_name, f_ext = os.path.splitext(filename)
    assert f_ext == ".recordio"
    if feed_order is None:
        feed_order = [v.name for v in feeder.feed_vars]
    counter = 0
    shard = []
    f_idx = 0

    def flush(batches, idx):
        return convert_reader_to_recordio_file(
            f"{f_name}-{idx:05d}{f_ext}", lambda: iter(batches), feeder,
            compressor, max_num_records, feed_order)

    for batch in reader_creator():
        shard.append(batch)
        if len(shard) == batch_per_file:
            counter += flush(shard, f_idx)
            shard, f_idx = [], f_idx + 1
    if shard:
        counter += flush(shard, f_idx)
    return counter


def read_recordio_file(filename):
    """Yield the {name: ndarray} feed dicts back out of a recordio file
    (the reader half: reference operators/reader recordio reader op)."""
    from paddle_tpu_torch import native
    from paddle_tpu_torch.distributed.rpc import wire_loads

    scanner = native.RecordIOScanner(filename)
    try:
        for rec in scanner:
            yield wire_loads(rec)
    finally:
        scanner.close()
