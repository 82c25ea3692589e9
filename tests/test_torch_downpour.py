"""Downpour CTR training on the port against the JAX package.

- Plans: ``TrainerFactory`` and ``DeviceWorkerFactory`` pick the same
  trainer and device worker and write the same descriptors as the JAX
  package's; ``DownpourSGD.minimize`` gives the same ``opt_info`` on a
  one-table program, and both packages refuse DeepFM's two tables;
  ``PaddlePSInstance``'s role arithmetic matches over a grid of modes,
  nodes and ranks.
- Lockstep (a tiny DeepFM, ``is_distributed`` tables, 2 async pservers
  on threads of this process, 1 trainer, ``push_window=1``,
  ``pull_dense_every=1``): the port's ``DownpourRunner`` is bitwise the
  port's local SGD run in every loss, parameter and table pulled back
  from the pservers, and within 1e-5 of the JAX package's Downpour run;
  the port's runner against the JAX package's pservers matches too.
- Asynchronous: 2 trainers on threads, each through
  ``train_from_dataset`` over MultiSlot files (``push_window=3``,
  ``pull_dense_every=2``, 80 batches each), converge under the JAX test's bar
  (``tests/test_dist_ps.py:709-818``); ``train_from_dataset`` hands the
  loop to a ``downpour_runner`` it is given.
"""

from __future__ import annotations

import itertools
import socket
import threading

import numpy as np
import pytest
import torch
from torch_port_helpers import fresh_port_programs

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.models.deepfm import deepfm_model as jax_deepfm
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.models.deepfm import deepfm_model as port_deepfm

VOCAB, FIELDS, DENSE, LR = 64, 4, 3, 0.5
STEPS, BATCH, SEED = 10, 64, 7
TRUTH = np.arange(VOCAB, dtype=np.float32) % 5 - 2.0


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _feeds(seed, n=STEPS):
    """The JAX test's data: each id's truth is id % 5 - 2, a row's label
    whether its truth summed over the fields is above 0."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        bi = rng.randint(0, VOCAB, (BATCH, FIELDS, 1)).astype(np.int64)
        bx = rng.rand(BATCH, DENSE).astype(np.float32)
        by = (TRUTH[bi[:, :, 0]].sum(1, keepdims=True) > 0).astype(np.int64)
        out.append({"sparse_ids": bi, "dense_x": bx, "label": by})
    return out


def _deepfm(pkg):
    """(main, startup, model) of the tiny DeepFM under SGD."""
    main, startup = pkg.Program(), pkg.Program()
    build = jax_deepfm if pkg is fluid else port_deepfm
    with pkg.program_guard(main, startup):
        with pkg.unique_name.guard():
            model = build(num_fields=FIELDS, vocab_size=VOCAB, embed_dim=4,
                          dense_dim=DENSE, hidden=(16,), is_sparse=False,
                          is_distributed=True)
            pkg.optimizer.SGD(LR).minimize(model["loss"])
    return main, startup, model


def _transpile(pkg, main, startup, eps, trainer_id=0, trainers=1):
    cfg = pkg.transpiler.DistributeTranspilerConfig()
    cfg.min_block_size = 1
    t = pkg.transpiler.DistributeTranspiler(cfg)
    t.transpile(trainer_id, program=main, startup_program=startup,
                pservers=",".join(eps), trainers=trainers, sync_mode=False)
    return t


def _serve(pkg, t, ep, errors):
    """One pserver of ``pkg`` on a thread of this process."""
    from paddle_tpu.core.scope import Scope as JaxScope

    def run():
        try:
            main, startup = t.get_pserver_programs(ep)
            exe = pkg.Executor(pkg.CPUPlace())
            scope = Scope() if pkg is pt else JaxScope()
            exe.run(startup, scope=scope)
            exe.run(main, scope=scope)
        except BaseException as e:   # noqa: BLE001 (reported below)
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _complete(pkg, eps, trainers=1):
    from paddle_tpu.distributed.rpc import global_rpc_client as jax_client

    from paddle_tpu_torch.distributed.rpc import global_rpc_client

    client = (global_rpc_client if pkg is pt else jax_client)()
    for ep in eps:
        for k in range(trainers):
            client.send_complete(ep, peer_id=f"trainer{k}")


def _to_np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _lockstep(trainer_pkg, pserver_pkg, feeds):
    """A Downpour run of 1 trainer and 2 async pservers in lockstep: the
    losses and every parameter and table pulled back at the end."""
    if trainer_pkg is pt:
        from paddle_tpu_torch.distributed.downpour_worker import \
            DownpourRunner
    else:
        from paddle_tpu.core.scope import Scope as TrainerScope
        from paddle_tpu.distributed.downpour_worker import DownpourRunner
    eps = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    errors = []
    ps_main, ps_startup, _ = _deepfm(pserver_pkg)
    threads = [_serve(pserver_pkg, _transpile(pserver_pkg, ps_main,
                                              ps_startup, eps), ep, errors)
               for ep in eps]
    main, startup, model = _deepfm(trainer_pkg)
    t = _transpile(trainer_pkg, main, startup, eps)
    try:
        trainer_pkg.transpiler.wait_server_ready(eps, timeout=30)
        exe = trainer_pkg.Executor(trainer_pkg.CPUPlace())
        scope = Scope() if trainer_pkg is pt else TrainerScope()
        np.random.seed(SEED)
        exe.run(t.get_trainer_startup_program(), scope=scope)
        runner = DownpourRunner(t, program=main, scope=scope, executor=exe,
                                push_window=1, pull_dense_every=1)
        losses = [float(_to_np(runner.run_step(f, [model["loss"]])[0]))
                  for f in feeds]
        runner.drain()
        final = dict(runner._fleet_pull.pull_dense_vars_sync())
        for w in runner.table_ids:
            ids, rows = runner._fleet_pull.pull_sparse_rows_sync(
                w, np.arange(VOCAB))
            assert ids.tolist() == list(range(VOCAB))
            final[w] = rows
        stats = getattr(runner, "stats", None)
        runner.finish()
    finally:
        _complete(trainer_pkg, eps)
        for th in threads:
            th.join(timeout=30)
    assert not errors and not any(th.is_alive() for th in threads)
    return losses, final, stats


def _local_port(feeds):
    with fresh_port_programs():
        main, startup, model = _deepfm(pt)
        exe = pt.Executor(pt.CPUPlace())
        np.random.seed(SEED)
        scope = Scope()
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed=f, fetch_list=[model["loss"]],
                                scope=scope)[0]) for f in feeds]
        names = [n for n, v in main.global_block().vars.items()
                 if v.persistable and not n.startswith("learning_rate")
                 and scope.find_var(n) is not None]
        return losses, {n: scope.find_var(n).get().numpy() for n in names}


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

_OPT_INFOS = {
    "none": None,
    "hogwild": {"trainer": "MultiTrainer", "device_worker": "Hogwild"},
    "downpour": {"trainer": "DistMultiTrainer",
                 "device_worker": "DownpourSGD",
                 "sparse_tables": ["emb"], "dense_tables": ["fc_0.w_0"],
                 "skip_ops": ["lookup_table", "lookup_table_grad"],
                 "fleet_desc": "desc"},
    "section": {"trainer": "PipelineTrainer", "device_worker": "Section"},
}


def _trainer_desc(pkg, opt_info):
    from paddle_tpu.trainer_desc import TrainerFactory as JaxFactory

    from paddle_tpu_torch.trainer_desc import TrainerFactory

    trainer = (TrainerFactory if pkg is pt else JaxFactory)()._create_trainer(
        opt_info)
    prog = pkg.Program()
    prog._fleet_opt = opt_info
    prog._pipeline_opt = {"sections": [0, 1, 2], "num_microbatches": 4}
    trainer._set_program(prog)
    trainer._set_thread(3)
    trainer._set_debug(True)
    trainer._set_fetch_var_and_info(["loss"], ["the loss"], 7)
    trainer._set_infer(True)
    trainer._gen_trainer_desc()
    fields = ("class_name", "trainer_name", "device_worker_name", "skip_ops",
              "sparse_tables", "dense_tables", "section_num",
              "num_microbatches", "queue_size", "start_cpu_core_id",
              "_fleet_desc")
    return trainer._desc(), {f: getattr(trainer, f, None) for f in fields}


@pytest.mark.parametrize("which", sorted(_OPT_INFOS))
def test_trainer_and_device_worker_choices_match_jax(which):
    assert _trainer_desc(pt, _OPT_INFOS[which]) == \
        _trainer_desc(fluid, _OPT_INFOS[which])


def test_unknown_device_worker_raises_like_jax():
    from paddle_tpu.device_worker import DeviceWorkerFactory as Jax

    from paddle_tpu_torch.device_worker import DeviceWorkerFactory

    for factory in (Jax, DeviceWorkerFactory):
        with pytest.raises(ValueError, match="unknown device worker"):
            factory()._create_device_worker("Nope")


def _one_table(pkg):
    layers = pkg.layers
    ids = layers.data("ids", shape=[5, 1], dtype="int64")
    x = layers.data("x", shape=[3], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    emb = layers.embedding(ids, size=[40, 2], is_sparse=True,
                           is_distributed=True)
    pred = layers.elementwise_add(
        layers.reduce_sum(layers.reduce_sum(emb, dim=[1]), dim=[1],
                          keep_dim=True), layers.fc(x, size=1))
    return layers.mean(layers.square_error_cost(pred, y))


def test_downpour_sgd_opt_info_matches_jax_on_one_table():
    from paddle_tpu.distributed.downpour import DownpourSGD as JaxDownpour

    from paddle_tpu_torch.distributed.downpour import DownpourSGD

    want = JaxDownpour(0.1, window=2).minimize([_one_table(fluid)])
    with fresh_port_programs():
        loss = _one_table(pt)
        got = DownpourSGD(0.1, window=2).minimize([loss])
        assert loss.block.program._fleet_opt is got[0]
        types = [op.type for op in loss.block.program.global_block().ops]
    assert got == want
    assert got[0]["sparse_tables"] == ["embedding_0.w_0"]
    assert "lookup_table_grad" in types and "sgd" not in types
    with pytest.raises(ValueError, match="list"):
        DownpourSGD().minimize(loss)


def test_both_packages_refuse_deepfm_two_tables():
    from paddle_tpu.distributed.downpour import DownpourSGD as JaxDownpour

    from paddle_tpu_torch.distributed.downpour import DownpourSGD

    for pkg, opt in ((fluid, JaxDownpour), (pt, DownpourSGD)):
        main, startup = pkg.Program(), pkg.Program()
        build = jax_deepfm if pkg is fluid else port_deepfm
        with pkg.program_guard(main, startup):
            with pkg.unique_name.guard():
                model = build(num_fields=FIELDS, vocab_size=VOCAB,
                              embed_dim=4, dense_dim=DENSE, hidden=(16,),
                              is_sparse=False, is_distributed=True)
                with pytest.raises(ValueError, match="share one table"):
                    opt(0.1).minimize([model["loss"]])


def _roles(cls, mode, ppn, nodes):
    out = []
    for rank in range(nodes * ppn + 1):
        try:
            inst = cls(server_worker_mode=mode, proc_per_node=ppn,
                       nodes=nodes, rankid=rank)
        except ValueError as e:
            out.append(("raises", str(e)))
            continue
        out.append((inst.is_worker(), inst.is_server(),
                    inst.is_first_worker(), inst.get_worker_index(),
                    inst.get_server_index(), inst.get_worker_num(),
                    inst.get_server_num(), inst.get_node_cnt(),
                    inst.gather_ips()))
        inst.barrier_all()
        inst.barrier_worker()
    return out


@pytest.mark.parametrize("mode,ppn,nodes", list(itertools.product(
    (0, 1, 2), (1, 2, 4), (1, 3))))
def test_ps_instance_role_arithmetic_matches_jax(mode, ppn, nodes,
                                                 monkeypatch):
    from paddle_tpu.distributed.ps_instance import PaddlePSInstance as Jax

    from paddle_tpu_torch.distributed.ps_instance import PaddlePSInstance

    monkeypatch.delenv("PADDLE_BARRIER_ENDPOINT", raising=False)
    assert _roles(PaddlePSInstance, mode, ppn, nodes) == \
        _roles(Jax, mode, ppn, nodes)


# ---------------------------------------------------------------------------
# lockstep: bitwise the local run, near the JAX package's
# ---------------------------------------------------------------------------

def test_downpour_lockstep_is_bitwise_local_and_holds_jax():
    feeds = _feeds(100)
    want, local = _local_port(feeds)
    with fresh_port_programs():
        got, final, stats = _lockstep(pt, pt, feeds)
    assert got == want
    assert set(final) <= set(local)
    assert {"embedding_0.w_0", "embedding_1.w_0", "fc_0.w_0",
            "fc_1.b_0"} <= set(final)
    for n, v in final.items():
        assert np.array_equal(v, local[n]), n
    assert stats["steps"] == STEPS and stats["pulled_bytes"] > 0
    jax_losses, jax_final, _ = _lockstep(fluid, fluid, feeds)
    np.testing.assert_allclose(got, jax_losses, rtol=1e-5)
    for n, v in jax_final.items():
        np.testing.assert_allclose(final[n], v, rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    assert got[-1] < got[0]


def test_port_runner_against_jax_pservers_holds_jax():
    feeds = _feeds(101)
    want, want_final, _ = _lockstep(fluid, fluid, feeds)
    with fresh_port_programs():
        got, final, _ = _lockstep(pt, fluid, feeds)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n, v in want_final.items():
        np.testing.assert_allclose(final[n], v, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# asynchronous: 2 trainers through train_from_dataset
# ---------------------------------------------------------------------------

def _write_files(tmp_path, trainer_id, batches=80):
    rng = np.random.RandomState(100 + trainer_id)
    path = str(tmp_path / f"trainer{trainer_id}.txt")
    with open(path, "w") as f:
        for _ in range(batches * BATCH):
            ids = rng.randint(0, VOCAB, FIELDS)
            x = rng.rand(DENSE)
            label = int(TRUTH[ids].sum() > 0)
            f.write(f"{FIELDS} " + " ".join(map(str, ids))
                    + f" {DENSE} " + " ".join(f"{v:.6f}" for v in x)
                    + f" 1 {label}\n")
    return [path]


def test_downpour_two_async_trainers_converge_through_train_from_dataset(
        tmp_path):
    eps = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    errors, losses = [], {0: [], 1: []}
    with fresh_port_programs():
        ps_main, ps_startup, _ = _deepfm(pt)
        threads = [_serve(pt, _transpile(pt, ps_main, ps_startup, eps,
                                         trainers=2), ep, errors)
                   for ep in eps]
        trainers = []
        try:
            pt.transpiler.wait_server_ready(eps, timeout=30)
            for k in range(2):        # trainer 0 pushes the start first
                main, startup, model = _deepfm(pt)
                t = _transpile(pt, main, startup, eps, trainer_id=k,
                               trainers=2)
                exe = pt.Executor(pt.CPUPlace())
                scope = Scope()
                np.random.seed(SEED)
                exe.run(t.get_trainer_startup_program(), scope=scope)
                main._fleet_opt = {"trainer": "DistMultiTrainer",
                                   "device_worker": "DownpourSGD",
                                   "transpiler": t, "push_window": 3,
                                   "pull_dense_every": 2}
                ds = pt.DatasetFactory().create_dataset("QueueDataset")
                ds.set_batch_size(BATCH)
                ds.set_filelist(_write_files(tmp_path, k))
                ds.set_use_var([model["sparse_ids"], model["dense_x"],
                                model["label"]])
                trainers.append((exe, main, scope, ds, model["loss"]))

            def train(k):
                exe, main, scope, ds, loss = trainers[k]
                exe.train_from_dataset(main, ds, scope=scope,
                                       fetch_list=[loss])
                runner = main._fleet_opt["downpour_runner"]
                losses[k] = [float(r[0]) for r in runner.results]
                runner.finish()

            workers = [threading.Thread(target=train, args=(k,))
                       for k in range(2)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=120)
        finally:
            _complete(pt, eps, trainers=2)
            for th in threads:
                th.join(timeout=30)
    assert not errors
    for k in range(2):
        tl = losses[k]
        assert len(tl) == 80, k
        # async staleness tolerated: the JAX test's bar
        assert np.mean(tl[-5:]) < tl[0] * 0.6, tl[::8]


def test_train_from_dataset_dispatches_downpour_runner():
    seen = []

    class _StubRunner:
        def train_from_dataset(self, dataset, fetch_list):
            seen.append((dataset, tuple(fetch_list)))

    class _StubDataset:
        _thread = 1

        def _iter_batches(self):
            return iter(())

    with fresh_port_programs():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        y = pt.layers.data("y", shape=[1], dtype="float32")
        loss = pt.layers.mean(pt.layers.square_error_cost(
            pt.layers.fc(x, 1), y))
        pt.optimizer.SGD(0.1).minimize(loss)
        prog = pt.default_main_program()
        prog._fleet_opt = {"trainer": "DistMultiTrainer",
                           "device_worker": "DownpourSGD",
                           "downpour_runner": _StubRunner()}
        exe = pt.Executor(pt.CPUPlace())
        exe.run(pt.default_startup_program())
        ds = _StubDataset()
        assert exe.train_from_dataset(prog, ds, fetch_list=[loss]) is None
    assert seen and seen[0][0] is ds and seen[0][1] == (loss,)
