"""The port's collective ops, new op types and collective server against
the JAX package.

- The 14 collective op types at world 1 (no mesh: a ring of one
  participant) equal the JAX ops, which are the identity outside
  ``shard_map`` (array_equal).
- At world 2 and 4 the reducing and moving ops run in gloo process
  groups of as many CPU processes (one spawn a world for every case) and
  are held against the JAX op's compute under ``penv.shard_map`` over as
  many of the 8 virtual CPU devices, with its ring registered: the moving
  ops, a sum over 2 ranks, max and min exact, the rest at rtol 1e-6.
- ``increment``, the comparison family and ``where`` against the JAX ops
  (array_equal).
- The collective server: the JAX package's two contracts over the port,
  and a gather mixing the packages' servers and clients.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

from paddle_tpu.core.registry import get_op_def as jax_def
from paddle_tpu.parallel import env as jenv
from torch_port_helpers import run_port_cluster

import paddle_tpu_torch  # noqa: F401  (registers every op)
from paddle_tpu_torch.core.registry import get_op_def as port_def
from paddle_tpu_torch.parallel import env as penv

CPU = torch.device("cpu")


def _port(op, ins, attrs):
    d = port_def(op)
    return d.compute({k: torch.from_numpy(np.asarray(v)) for k, v in
                      ins.items()}, d.canonical_attrs(attrs), CPU)


def _jax(op, ins, attrs):
    d = jax_def(op)
    return d.compute({k: jnp.asarray(v) for k, v in ins.items()},
                     d.canonical_attrs(attrs))


# jax without x64 holds int64 and float64 as their 32-bit types
_NARROW = {np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.float64): np.dtype(np.float32)}


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert _NARROW.get(got.dtype, got.dtype) == want.dtype, (got.dtype,
                                                             want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# world 1: the 14 op types
# ---------------------------------------------------------------------------

_X = np.random.RandomState(0).standard_normal((4, 3)).astype(np.float32)

WORLD1 = [
    ("c_allreduce_sum", {"X": _X}, {"ring_id": 0}),
    ("c_allreduce_max", {"X": _X}, {}),
    ("c_allreduce_min", {"X": _X}, {}),
    ("c_allreduce_prod", {"X": _X}, {"ring_id": 1}),
    ("c_allgather", {"X": _X}, {"nranks": 1}),
    ("c_reducescatter", {"X": _X}, {"nranks": 1}),
    ("c_broadcast", {"X": _X}, {"root": 0}),
    ("c_sync_calc_stream", {"X": _X}, {}),
    ("c_sync_comm_stream", {"X": _X}, {}),
    ("c_comm_init", {}, {"nranks": 1, "rank": 0}),
    ("c_gen_nccl_id", {}, {"rank": 0, "endpoint": "127.0.0.1:1"}),
    ("all_to_all", {"X": _X}, {"split_axis": 0, "concat_axis": 1}),
    ("allreduce", {"X": _X}, {"reduce_type": 3}),
    ("broadcast", {"X": _X}, {"root": 0}),
]


@pytest.fixture
def no_mesh():
    penv.reset()
    jenv.reset()
    yield
    penv.reset()
    jenv.reset()


@pytest.mark.parametrize("op,ins,attrs", WORLD1,
                         ids=[c[0] for c in WORLD1])
def test_collective_op_at_world_one_equals_jax(no_mesh, op, ins, attrs):
    got, want = _port(op, ins, attrs), _jax(op, ins, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        _same(got[slot], want[slot])
    d, j = port_def(op), jax_def(op)
    assert (d.inputs, d.outputs, d.attrs, d.host_only) == \
        (j.inputs, j.outputs, j.attrs, j.host_only)


def test_fourteen_collective_op_types_are_registered():
    assert len({c[0] for c in WORLD1}) == 14
    assert port_def("sync_batch_norm").attrs == jax_def(
        "sync_batch_norm").attrs


# ---------------------------------------------------------------------------
# worlds 2 and 4: gloo process groups against shard_map
# ---------------------------------------------------------------------------

def _cases(world):
    """(op, attrs, input shape, exact?) of the reducing and moving ops."""
    return [
        ("c_allreduce_sum", {}, (3, 5), world == 2),
        ("c_allreduce_max", {}, (3, 5), True),
        ("c_allreduce_min", {}, (3, 5), True),
        ("c_allreduce_prod", {}, (3, 5), False),
        ("c_allgather", {"nranks": world}, (2, 3), True),
        ("c_reducescatter", {"nranks": world}, (2 * world, 3), world == 2),
        ("c_broadcast", {"root": 1}, (3, 5), True),
        ("all_to_all", {"split_axis": 0, "concat_axis": 1},
         (2 * world, 3), True),
        ("allreduce", {"reduce_type": 0}, (3, 5), world == 2),
        ("allreduce", {"reduce_type": 1}, (3, 5), True),
        ("allreduce", {"reduce_type": 2}, (3, 5), True),
        ("allreduce", {"reduce_type": 3}, (3, 5), False),
        ("broadcast", {"root": world - 1}, (3, 5), True),
    ]


def _rank_input(i, rank, shape):
    x = np.random.RandomState(100 * i + rank).standard_normal(shape)
    # a zero and negatives, so prod is held exactly where it is subtle
    x.reshape(-1)[0] = 0.0 if rank == 0 else x.reshape(-1)[0]
    return x.astype(np.float32)


_RANK_SCRIPT = r"""
import json, os
import numpy as np, torch
torch.set_num_threads(1)
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.parallel import env as penv

args = json.loads(os.environ["PT_CLUSTER_ARGS"])
rank = int(os.environ["PADDLE_TRAINER_ID"])
world = int(os.environ["PADDLE_TRAINERS_NUM"])
penv.init_parallel_env(rank, world, os.environ["PADDLE_COORDINATOR_ENDPOINT"],
                       place=pt.CPUPlace())
penv.set_mesh(penv.make_mesh())
out = {"backend": penv.backend()}
for i, (op, attrs, shape, _) in enumerate(args["cases"]):
    x = np.random.RandomState(100 * i + rank).standard_normal(shape)
    x.reshape(-1)[0] = 0.0 if rank == 0 else x.reshape(-1)[0]
    d = get_op_def(op)
    got = d.compute({"X": torch.from_numpy(x.astype(np.float32))},
                    d.canonical_attrs(attrs), torch.device("cpu"))["Out"]
    out[str(i)] = got.numpy().astype(np.float64).tolist()
out["routes"] = penv.routes()
penv.shutdown()
print("RESULT " + json.dumps(out))
"""

_CLUSTERS = {}


def _cluster(world):
    """Every case of ``world`` from one spawn of its cluster."""
    if world not in _CLUSTERS:
        _CLUSTERS[world] = run_port_cluster(
            _RANK_SCRIPT, world, {"cases": _cases(world)}, timeout=240)
    return _CLUSTERS[world]


def _jax_reference(world, i, op, attrs, shape):
    """The JAX op's compute under shard_map over ``world`` CPU devices,
    ring 0 registered on the mesh axis: each device's output."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("dp",))
    xs = np.stack([_rank_input(i, r, shape) for r in range(world)])
    d = jax_def(op)
    full = d.canonical_attrs(attrs)

    def f(xb):
        return d.compute({"X": xb[0]}, full)["Out"][None]

    jenv.reset()
    jenv.register_ring(0, "dp")
    try:
        return np.asarray(jenv.shard_map(f, mesh, in_specs=JP("dp"),
                                         out_specs=JP("dp"))(xs))
    finally:
        jenv.reset()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("i", range(13))
def test_collective_op_over_ranks_equals_jax_shard_map(world, i):
    op, attrs, shape, exact = _cases(world)[i]
    results = _cluster(world)
    want = _jax_reference(world, i, op, attrs, shape)
    for rank, res in enumerate(results):
        assert res["backend"] == "gloo"
        got = np.asarray(res[str(i)], dtype=np.float32)
        if exact:
            np.testing.assert_array_equal(got, want[rank], err_msg=op)
        else:
            np.testing.assert_allclose(got, want[rank], rtol=1e-6,
                                       atol=0, err_msg=op)


# ---------------------------------------------------------------------------
# increment, the comparison family and where
# ---------------------------------------------------------------------------

_r = np.random.RandomState(3)
_A = _r.randint(-3, 4, (2, 3, 4)).astype(np.float32)
_B = _r.randint(-3, 4, (2, 3, 4)).astype(np.float32)
_C = _r.randint(-3, 4, (3,)).astype(np.float32)

NEW_OPS = [
    ("increment", {"X": np.array([5], np.int64)}, {"step": 1.0}),
    ("increment", {"X": _A}, {"step": 0.5}),
    ("equal", {"X": _A, "Y": _B}, {}),
    ("not_equal", {"X": _A, "Y": _B}, {}),
    ("less_than", {"X": _A, "Y": _C}, {"axis": 1}),
    ("less_equal", {"X": _A, "Y": _B}, {}),
    ("greater_than", {"X": _A, "Y": _B}, {}),
    ("greater_equal", {"X": _A, "Y": _C}, {"axis": 1}),
    ("logical_and", {"X": _A > 0, "Y": _B > 0}, {}),
    ("logical_or", {"X": _A > 0, "Y": _B > 0}, {}),
    ("logical_xor", {"X": _A > 0, "Y": _B > 0}, {}),
    ("logical_not", {"X": _A > 0}, {}),
    ("where", {"Condition": _A > 0, "X": _A, "Y": _B}, {}),
    ("where", {"Condition": np.array([True]), "X": _A, "Y": _B}, {}),
]


@pytest.mark.parametrize("op,ins,attrs", NEW_OPS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(NEW_OPS)])
def test_new_op_type_equals_jax(op, ins, attrs):
    _same(_port(op, ins, attrs)["Out"], _jax(op, ins, attrs)["Out"])


# ---------------------------------------------------------------------------
# the collective server
# ---------------------------------------------------------------------------

def _servers(pkg, n):
    if pkg == "jax":
        from paddle_tpu.distributed.collective_server import CollectiveServer
    else:
        from paddle_tpu_torch.distributed import CollectiveServer
    return [CollectiveServer().start() for _ in range(n)]


def _client(pkg):
    if pkg == "jax":
        from paddle_tpu.distributed.collective_server import CollectiveClient
    else:
        from paddle_tpu_torch.distributed import CollectiveClient
    return CollectiveClient()


def test_port_collective_server_gather_rank_order():
    """tests/test_inventory_gaps_r4.py's gather over the port: rank 1
    registers late from another thread, SelectedRows and dense."""
    servers = _servers("port", 2)
    try:
        servers[0].register_var(
            "g", np.full((3, 2), 0.0, np.float32), rows=np.array([0, 4, 7]))
        threading.Timer(0.3, lambda: servers[1].register_var(
            "g", torch.full((2, 2), 1.0), rows=np.array([2, 5]))).start()
        client = _client("port")
        out = client.gather([(s.endpoint, "g") for s in servers],
                            timeout=10.0)
        (r0, v0), (r1, v1) = out
        np.testing.assert_array_equal(np.asarray(r0), [0, 4, 7])
        np.testing.assert_array_equal(np.asarray(r1), [2, 5])
        assert np.asarray(v0).shape == (3, 2)
        assert float(np.asarray(v1).sum()) == 4.0
        servers[0].register_var("d", np.arange(4, dtype=np.float32))
        (d,) = client.gather([(servers[0].endpoint, "d")])
        np.testing.assert_array_equal(np.asarray(d), [0.0, 1.0, 2.0, 3.0])
        client.close()
    finally:
        for s in servers:
            s.stop()


def test_port_collective_server_remote_register():
    from paddle_tpu_torch.distributed.rpc import RPCClient

    (s,) = _servers("port", 1)
    try:
        c = RPCClient()
        c.call(s.endpoint, "register_monomer",
               ("x", np.ones(3, np.float32), None))
        (v,) = _client("port").gather([(s.endpoint, "x")])
        np.testing.assert_array_equal(np.asarray(v), [1, 1, 1])
        c.close()
    finally:
        s.stop()


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_mixed_gather_across_packages(server_pkg, client_pkg):
    """A JAX CollectiveServer read by the port's client, and the other
    way round: the same arrays as a gather within one package."""
    rng = np.random.RandomState(9)
    dense = [rng.standard_normal((2, 3)).astype(np.float32)
             for _ in range(2)]
    rows = np.array([1, 6])
    servers = _servers(server_pkg, 2)
    try:
        for s, v in zip(servers, dense):
            s.register_var("w", v)
            s.register_var("sr", v, rows=rows)
        got = _client(client_pkg).gather(
            [(s.endpoint, n) for n in ("w", "sr") for s in servers])
        same = _client(server_pkg).gather(
            [(s.endpoint, n) for n in ("w", "sr") for s in servers])
        for g, w in zip(got[:2], dense):
            np.testing.assert_array_equal(np.asarray(g), w)
        for g, w in zip(got, same):
            if isinstance(w, tuple):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))
            else:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    finally:
        for s in servers:
            s.stop()
