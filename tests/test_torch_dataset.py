"""The port's dataset pipeline against the JAX package's.

- The native runtime (``paddle_tpu_torch/native``, built with g++ at
  first use): its MultiSlot parser, blocking queue and recordio files
  agree with the pure-Python fallback and with the JAX package's.
- The same MultiSlot, pipe_command and recordio files give
  ``array_equal`` batches through both packages' ``QueueDataset`` (one
  reader thread) and ``InMemoryDataset`` (after ``local_shuffle(seed)``);
  recordio files written by either package read in the other;
  ``DataFeedDesc`` parses and dumps alike.
- ``DeviceFeeder`` on the CPU hands out the batches as tensors, stops,
  and surfaces a reader's error; ``train_from_dataset``'s local loop
  (through ``DeviceFeeder``) is bitwise ``Executor.run`` on the same
  batches fed by hand, and its parameters end within 1e-5 of the JAX
  package's ``train_from_dataset``; ``AsyncExecutor`` runs a
  ``DataFeedDesc`` and a file list.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_port_helpers import fresh_port_programs

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import native as jax_native
from paddle_tpu_torch import native

FIELDS, VOCAB, DENSE = 4, 50, 3


def _write_ctr_files(tmp_path, n_files=2, lines=37, seed=0, ragged=False):
    """DeepFM-style MultiSlot text: FIELDS int ids, DENSE floats, a
    label; with ``ragged`` a fourth slot of 1-3 ids."""
    rng = np.random.RandomState(seed)
    paths = []
    for fi in range(n_files):
        path = str(tmp_path / f"part-{fi}")
        with open(path, "w") as f:
            for _ in range(lines):
                ids = rng.randint(0, VOCAB, FIELDS)
                x = rng.rand(DENSE)
                parts = [f"{FIELDS} " + " ".join(map(str, ids)),
                         f"{DENSE} " + " ".join(f"{v:.6f}" for v in x),
                         f"1 {int(ids.sum() % 2)}"]
                if ragged:
                    k = rng.randint(1, 4)
                    parts.append(f"{k} " + " ".join(
                        map(str, rng.randint(0, VOCAB, k))))
                f.write(" ".join(parts) + "\n")
        paths.append(path)
    return paths


def _ctr_vars(pkg, ragged=False):
    layers = pkg.layers
    out = [layers.data("sparse_ids", shape=[FIELDS, 1], dtype="int64"),
           layers.data("dense_x", shape=[DENSE], dtype="float32"),
           layers.data("label", shape=[1], dtype="int64")]
    if ragged:
        out.append(layers.data("seq", shape=[-1, 1], dtype="int64"))
    return out


def _batches(pkg, kind, paths, batch=8, ragged=False, shuffle=None,
             pipe=None):
    ds = pkg.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_thread(1)
    ds.set_filelist(paths)
    if pipe:
        ds.set_pipe_command(pipe)
    ds.set_use_var(_ctr_vars(pkg, ragged))
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        if shuffle is not None:
            ds.local_shuffle(seed=shuffle)
    return list(ds._iter_batches())


def _port_batches(*a, **k):
    with fresh_port_programs():
        return _batches(pt, *a, **k)


def _assert_same_batches(got, want):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].dtype == w[name].dtype, name
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


# ---------------------------------------------------------------------------
# the native runtime
# ---------------------------------------------------------------------------

def test_native_library_builds_and_parses_like_the_fallback_and_jax(
        monkeypatch):
    assert native.NATIVE
    text = b"2 0.5 1.5 1 7\n\n1 3 2 4 5\r\n3 1e-3 -2 4.25 1 -9\n"
    types = ["float", "int64"]
    got = native.MultiSlotParser(types).parse(text)
    want = jax_native.MultiSlotParser(types).parse(text)
    monkeypatch.setattr(native, "_load", lambda: None)
    fallback = native.MultiSlotParser(types).parse(text)
    for other in (want, fallback):
        assert got[0] == other[0] == 3
        for (gv, gl), (ov, ol) in zip(got[1], other[1]):
            assert gv.dtype == ov.dtype
            np.testing.assert_array_equal(gv, ov)
            np.testing.assert_array_equal(gl, ol)
    with pytest.raises(ValueError, match="malformed"):
        native.MultiSlotParser(types).parse(b"3 1 2\n")


@pytest.mark.parametrize("impl", ["native", "python"])
def test_blocking_queue_bounds_closes_and_drains(impl, monkeypatch):
    if impl == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
    q = native.BlockingQueue(capacity=2)
    assert q.push(b"a") and q.push(b"")
    assert q.size() == 2
    q.close()
    assert not q.push(b"c")
    assert [q.pop(), q.pop(), q.pop()] == [b"a", b"", None]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("python", "port")])
def test_recordio_chunks_read_across_packages(writer, reader, tmp_path,
                                              monkeypatch):
    rng = np.random.RandomState(3)
    records = [rng.bytes(int(n)) for n in rng.randint(0, 5000, 600)]
    path = str(tmp_path / "r.recordio")
    mods = {"port": native, "jax": jax_native, "python": native}
    if writer == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
    w = mods[writer].RecordIOWriter(path)
    for r in records:
        w.write(r)
    w.close()
    monkeypatch.undo()
    s = mods[reader].RecordIOScanner(path)
    assert list(s) == records
    s.close()


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True])
def test_queue_dataset_batches_equal_jax(tmp_path, ragged):
    paths = _write_ctr_files(tmp_path, ragged=ragged)
    want = _batches(fluid, "QueueDataset", paths, ragged=ragged)
    got = _port_batches("QueueDataset", paths, ragged=ragged)
    _assert_same_batches(got, want)
    assert got[0]["sparse_ids"].shape == (8, FIELDS, 1)
    assert sum(b["label"].shape[0] for b in got) == 74


@pytest.mark.parametrize("shuffle", [None, 5])
def test_in_memory_dataset_batches_equal_jax(tmp_path, shuffle):
    paths = _write_ctr_files(tmp_path, ragged=True)
    want = _batches(fluid, "InMemoryDataset", paths, ragged=True,
                    shuffle=shuffle)
    got = _port_batches("InMemoryDataset", paths, ragged=True,
                        shuffle=shuffle)
    _assert_same_batches(got, want)


def test_pipe_command_batches_equal_jax(tmp_path):
    path = str(tmp_path / "raw")
    with open(path, "w") as f:
        for i in range(11):
            f.write(f"{i},{i + 1},{i + 2},{i + 3},0.{i},0.5,0.25,{i % 2}\n")
    # CSV -> MultiSlot: 4 ids, 3 floats, the label
    pipe = "sed 's/^/4 /; s/,/ /; s/,/ /; s/,/ /; s/,/ 3 /; s/,/ /; " \
           "s/,/ /; s/,/ 1 /'"
    for kind in ("QueueDataset", "InMemoryDataset"):
        want = _batches(fluid, kind, [path], batch=4, pipe=pipe)
        got = _port_batches(kind, [path], batch=4, pipe=pipe)
        _assert_same_batches(got, want)


class _Feeder:
    """The ``DataFeeder`` shape recordio_writer takes: feed_vars and
    feed(samples) -> {name: array}."""

    def __init__(self, feed_vars):
        self.feed_vars = feed_vars

    def feed(self, samples):
        return {v.name: np.stack([s[i] for s in samples]).astype(
            v.dtype).reshape((len(samples),) + tuple(v.shape[1:]))
            for i, v in enumerate(self.feed_vars)}


def _ctr_reader(seed, n=5, batch=6):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield [(rng.randint(0, VOCAB, (FIELDS, 1)), rng.rand(DENSE),
                    rng.randint(0, 2, (1,))) for _ in range(batch)]
    return reader


def test_recordio_files_and_datasets_agree_across_packages(tmp_path):
    from paddle_tpu.data_feeder import DataFeeder
    from paddle_tpu.recordio_writer import \
        convert_reader_to_recordio_file as jax_convert
    from paddle_tpu.recordio_writer import read_recordio_file as jax_read

    from paddle_tpu_torch.recordio_writer import (
        convert_reader_to_recordio_file, convert_reader_to_recordio_files,
        read_recordio_file)

    jax_path = str(tmp_path / "jax.recordio")
    assert jax_convert(jax_path, _ctr_reader(1),
                       DataFeeder(_ctr_vars(fluid))) == 5
    with fresh_port_programs():
        feeder = _Feeder(_ctr_vars(pt))
        port_path = str(tmp_path / "port.recordio")
        assert convert_reader_to_recordio_file(
            port_path, _ctr_reader(1), feeder) == 5
        assert convert_reader_to_recordio_files(
            str(tmp_path / "shard.recordio"), 2, _ctr_reader(1),
            feeder) == 5
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    for got, want in zip(read_recordio_file(jax_path), jax_read(port_path)):
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
    shards = sorted(str(p) for p in tmp_path.glob("shard-*.recordio"))
    assert len(shards) == 3
    for kind in ("QueueDataset", "InMemoryDataset"):
        want = _batches(fluid, kind, [jax_path], batch=4)
        _assert_same_batches(_port_batches(kind, [jax_path], batch=4), want)
        _assert_same_batches(_port_batches(kind, shards, batch=4), want)


def test_queue_dataset_reader_errors_surface(tmp_path):
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[1], dtype="float32")
        ds = pt.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(2)
        ds.set_use_var([x])
        ds.set_filelist([str(tmp_path / "missing.recordio")])
        with pytest.raises(RuntimeError, match="reader thread failed"):
            list(ds._iter_batches())
        good = tmp_path / "x.recordio"
        good.write_bytes(b"")
        ds.set_pipe_command("cat")
        ds.set_filelist([str(good)])
        with pytest.raises(RuntimeError, match="pipe_command"):
            list(ds._iter_batches())
        with pytest.raises(ValueError, match="unknown dataset"):
            pt.DatasetFactory().create_dataset("Nope")


_FEED_DESC = """
name: "MultiSlotDataFeed"
batch_size: 2
multi_slot_desc {
    slots {
        name: "sparse_ids"
        type: "uint64"
        is_dense: false
        is_used: false
    }
    slots {
        name: "dense_x"
        type: "float"
        is_dense: false
        is_used: false
    }
    slots {
        name: "label"
        type: "uint64"
        is_dense: false
        is_used: false
    }
}
"""


def test_data_feed_desc_parses_and_dumps_like_jax(tmp_path):
    from paddle_tpu.data_feed_desc import DataFeedDesc as JaxDesc

    from paddle_tpu_torch.data_feed_desc import DataFeedDesc

    path = tmp_path / "feed.proto"
    path.write_text(_FEED_DESC)
    descs = [JaxDesc(str(path)), DataFeedDesc(str(path))]
    for d in descs:
        d.set_batch_size(16)
        d.set_dense_slots(["dense_x"])
        d.set_use_slots(["sparse_ids", "dense_x", "label"])
    assert descs[0].proto_desc == descs[1].proto_desc
    assert descs[0].desc() == descs[1].desc()
    assert descs[1].batch_size() == 16
    assert descs[1].used_slots() == ["sparse_ids", "dense_x", "label"]
    reparsed = tmp_path / "again.proto"
    reparsed.write_text(descs[1].desc())
    assert DataFeedDesc(str(reparsed)).proto_desc == descs[1].proto_desc


# ---------------------------------------------------------------------------
# DeviceFeeder and the local train_from_dataset loop
# ---------------------------------------------------------------------------

def test_device_feeder_on_the_cpu_yields_tensors_and_surfaces_errors():
    from paddle_tpu_torch.reader import DeviceFeeder

    batches = [{"x": np.full((2, 3), i, np.float32),
                "ids": np.arange(4).reshape(2, 2) + i} for i in range(5)]
    feeder = DeviceFeeder(iter(batches), capacity=2, place=pt.CPUPlace())
    got = list(feeder)
    assert len(got) == 5
    for g, w in zip(got, batches):
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    with pytest.raises(StopIteration):
        next(feeder)
    feeder.stop()

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    feeder = DeviceFeeder(broken(), place=pt.CPUPlace())
    assert next(feeder)["x"].shape == (2, 3)
    with pytest.raises(OSError, match="disk gone"):
        next(feeder)
    host = DeviceFeeder(iter(batches[:1]), to_device=False)
    assert next(host) is batches[0]


def _ctr_model(pkg):
    sparse_ids, dense_x, label = _ctr_vars(pkg)
    emb = pkg.layers.embedding(sparse_ids, size=[VOCAB, 4])
    h = pkg.layers.concat([pkg.layers.reshape(emb, [-1, FIELDS * 4]),
                           dense_x], axis=1)
    logits = pkg.layers.fc(pkg.layers.fc(h, 8, act="relu"), 1)
    loss = pkg.layers.mean(pkg.layers.sigmoid_cross_entropy_with_logits(
        logits, pkg.layers.cast(label, "float32")))
    pkg.optimizer.SGD(0.5).minimize(loss)
    return loss


def test_train_from_dataset_is_bitwise_hand_fed_and_holds_jax(tmp_path):
    paths = _write_ctr_files(tmp_path, n_files=3, lines=40, seed=4)
    batches = _batches(fluid, "QueueDataset", paths)
    jloss = _ctr_model(fluid)
    jexe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(2)
    jexe.run(fluid.default_startup_program())
    ds = fluid.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(8)
    ds.set_filelist(paths)
    ds.set_use_var([fluid.default_main_program().global_block().var(n)
                    for n in ("sparse_ids", "dense_x", "label")])
    jexe.train_from_dataset(fluid.default_main_program(), ds,
                            fetch_list=[jloss])
    jax_params = {n: np.asarray(fluid.global_scope().find_var(n).get())
                  for n in ("embedding_0.w_0", "fc_0.w_0", "fc_0.b_0",
                            "fc_1.w_0", "fc_1.b_0")}

    with fresh_port_programs():
        loss = _ctr_model(pt)
        main = pt.default_main_program()
        exe = pt.Executor(pt.CPUPlace())
        runs = {}
        for how in ("dataset", "hand"):
            np.random.seed(2)
            scope = pt.Scope()
            exe.run(pt.default_startup_program(), scope=scope)
            losses = []
            if how == "hand":
                for feed in batches:
                    losses.append(exe.run(main, feed=feed, fetch_list=[loss],
                                          scope=scope)[0])
            else:
                ds = pt.DatasetFactory().create_dataset("QueueDataset")
                ds.set_batch_size(8)
                ds.set_thread(1)
                ds.set_filelist(paths)
                ds.set_use_var([main.global_block().var(n) for n in (
                    "sparse_ids", "dense_x", "label")])
                run = exe.run

                def recording(*a, **k):
                    out = run(*a, **k)
                    losses.append(out[0])
                    return out

                exe.run = recording
                try:
                    assert exe.train_from_dataset(main, ds, scope=scope,
                                                  fetch_list=[loss]) is None
                finally:
                    del exe.run
            runs[how] = (losses, scope)
        assert len(runs["dataset"][0]) == len(batches) == 15
        for a, b in zip(runs["dataset"][0], runs["hand"][0]):
            assert np.array_equal(a, b)
        for name, want in jax_params.items():
            got = runs["dataset"][1].find_var(name).get()
            assert torch.equal(got, runs["hand"][1].find_var(name).get())
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_async_executor_runs_a_data_feed_desc(tmp_path):
    from paddle_tpu_torch.async_executor import AsyncExecutor
    from paddle_tpu_torch.data_feed_desc import DataFeedDesc

    paths = _write_ctr_files(tmp_path, n_files=2, lines=32, seed=6)
    proto = tmp_path / "feed.proto"
    proto.write_text(_FEED_DESC)
    desc = DataFeedDesc(str(proto))
    desc.set_batch_size(16)
    desc.set_use_slots(["sparse_ids", "dense_x", "label"])
    with fresh_port_programs():
        loss = _ctr_model(pt)
        main = pt.default_main_program()
        exe = pt.Executor(pt.CPUPlace())
        np.random.seed(1)
        exe.run(pt.default_startup_program())
        w0 = pt.global_scope().find_var("fc_0.w_0").get().clone()
        aexe = AsyncExecutor(pt.CPUPlace())
        aexe.run(main, desc, paths, thread_num=2,
                 fetch_var_names=[loss.name])
        assert not torch.equal(w0, pt.global_scope().find_var(
            "fc_0.w_0").get())
