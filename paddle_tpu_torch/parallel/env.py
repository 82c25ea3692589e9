"""Parallel environment: the rank mesh over ``torch.distributed``, the
ring-id -> mesh-axis map, and the collectives the port issues.

Counterpart of ``paddle_tpu/parallel/env.py``.  The JAX package's mesh is
a ``jax.sharding.Mesh`` of devices, and its collectives are XLA ops that
ride the mesh inside ``shard_map``/``pjit``.  Here one process drives one
device, so a mesh is a grid of ranks (``Mesh``): each axis has the
process group of the ranks that differ only along it.  ``make_mesh``,
``set_mesh``, ``get_mesh``, ``register_ring``, ``ring_axis`` and
``reset`` keep their names; a ring id maps to an axis, and through it to
a process group.

The process group comes up from the ``PADDLE_*`` contract
(``init_parallel_env``, which ``fleet.init`` calls).  Its backend is
chosen by a rule, never by catching a failure: ``nccl`` when no two
ranks of a host share a device, ``gloo`` otherwise (NCCL refuses two
ranks on one device), and ``gloo`` for CPU places.  ``backend()``
reports it.  A rank's device is ``cuda:(local_rank % device_count)``.

Every collective goes through ``collective`` here, which counts it by
its route (``routes()``): ``nccl``, ``gloo`` (gloo handed the tensor where
it lies: the host, or the card, whose tensors gloo copies itself) or
``single`` (no process group: the identity, nothing sent).  The gloo
build of PyTorch takes card tensors for all-reduce, broadcast,
all-gather, reduce-scatter and all-to-all, so no route stages through a
host buffer of the port's own.

``data_parallel(mesh, axis)`` marks the thread's ops as one step of data
parallelism over ``axis``: batch-reducing ops (``batch_norm``,
``conv2d_bn_train``) then take statistics over the global batch
(``batch_group``), through ``all_reduce_sum`` and ``all_gather_stacked``,
whose adjoints are collectives too, so the grad ops' recomputed forwards
and their backwards issue the same collectives on every rank.

``make_hybrid_mesh`` and ``shard_map`` wait for the ``gspmd`` item
(ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_current_mesh = None
# ring_id -> mesh axis name; ring 0 defaults to the data axis
_rings: dict = {}
# what init_parallel_env brought up: backend, device, local rank/world
_env: dict = {}
_local = threading.local()
_route_counts: dict = {}
_route_lock = threading.Lock()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


# ---------------------------------------------------------------------------
# bringing the process group up
# ---------------------------------------------------------------------------

def _host(endpoint):
    return endpoint.rsplit(":", 1)[0]


def local_layout(rank, world, endpoints=(), current=""):
    """(local rank, ranks on this host): the ranks whose trainer
    endpoint names the current endpoint's host, in rank order; without
    endpoints every rank is local."""
    endpoints = [e for e in endpoints if e]
    if len(endpoints) != world or not current:
        return rank, world
    local = [i for i, e in enumerate(endpoints)
             if _host(e) == _host(current)]
    if rank not in local:
        return rank, world
    return local.index(rank), len(local)


def choose_backend(device, local_world):
    """The backend rule: ``gloo`` for a CPU device; ``nccl`` when this
    host's ranks each have a device of their own; ``gloo`` when two of
    them share one (NCCL refuses a second rank on a device)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(local_rank, place=None):
    """A rank's device: ``place``'s, else ``cuda:(local_rank %
    device_count)``; raises ``NoCUDADeviceError`` without a card."""
    from paddle_tpu_torch.core.types import CUDAPlace

    if place is not None:
        return place.torch_device()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return CUDAPlace(local_rank % n).torch_device()


def init_parallel_env(rank, world, endpoint, place=None, endpoints=(),
                      current=""):
    """Brings ``torch.distributed`` up for ``rank`` of ``world`` with its
    store at ``endpoint`` (rank 0 listens there) and returns the backend.
    A second call in a process that is already up changes nothing
    (``fleet.init`` may run twice, as in the JAX package)."""
    if dist.is_initialized():
        return backend()
    local_rank, local_world = local_layout(rank, world, endpoints, current)
    device = rank_device(local_rank, place)
    chosen = choose_backend(device, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {}
    if chosen == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(
        chosen, init_method=f"tcp://{endpoint}", world_size=int(world),
        rank=int(rank), **kwargs)
    _env.update(backend=chosen, device=device, local_rank=local_rank,
                local_world=local_world)
    return chosen


def backend() -> Optional[str]:
    """The process group's backend (``nccl`` or ``gloo``), None when
    ``torch.distributed`` is not up."""
    if not is_initialized():
        return None
    return _env.get("backend") or dist.get_backend()


def device() -> Optional[torch.device]:
    """The device ``init_parallel_env`` gave this rank."""
    return _env.get("device")


def default_device_id() -> int:
    """The CUDA device index an ``Executor()`` with no place takes: this
    rank's, once the parallel env is up, else 0."""
    d = _env.get("device")
    return d.index if d is not None and d.type == "cuda" else 0


def shutdown():
    """Destroys the process group (the end of a rank's job)."""
    if is_initialized():
        dist.destroy_process_group()
    _env.clear()
    reset()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A grid of ranks: ``axis_names``, ``shape`` ({axis: size}, as a
    ``jax.sharding.Mesh`` has it), and for each axis the process group of
    the ranks that differ only along it (None when ``torch.distributed``
    is not up: a world of one, where every collective is the
    identity)."""

    def __init__(self, shape, axis_names, groups, coords):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self._groups = dict(zip(self.axis_names, groups))
        self._coords = dict(zip(self.axis_names, coords))

    def group(self, axis):
        """The process group along ``axis`` (None: a world of one)."""
        return self._groups[axis]

    def axis_index(self, axis):
        """This rank's coordinate along ``axis``."""
        return self._coords[axis]

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(shape=None, axis_names=None, devices=None):
    """A mesh over the world's ranks; default a 1-D mesh named 'dp'.
    ``devices`` (one a rank, as places or devices), when given, must
    number the ranks: one process drives one device."""
    world = world_size()
    if devices is not None and len(devices) != world:
        raise ValueError(
            f"make_mesh: {len(devices)} devices for {world} ranks; the "
            "port runs one process a device (start one a device with "
            "python -m paddle_tpu_torch.launch --nproc_per_node N)")
    if shape is None:
        shape = (world,)
        axis_names = axis_names or ("dp",)
    shape = tuple(int(s) for s in shape)
    if axis_names is None or len(axis_names) != len(shape):
        raise ValueError(f"make_mesh: axis names {axis_names} for shape "
                         f"{shape}")
    if int(np.prod(shape, dtype=np.int64)) != world:
        raise ValueError(f"make_mesh: shape {shape} holds "
                         f"{int(np.prod(shape))} ranks, the world has "
                         f"{world}")
    grid = np.arange(world).reshape(shape)
    me = rank()
    coords = tuple(int(c[0]) for c in np.nonzero(grid == me))
    groups = []
    for a in range(len(shape)):
        if not is_initialized():
            groups.append(None)
            continue
        if len(shape) == 1:
            groups.append(dist.group.WORLD)
            continue
        # every rank creates every group of the axis, in one order
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        mine = None
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                mine = g
        groups.append(mine)
    return Mesh(shape, axis_names, groups, coords)


def set_mesh(mesh):
    global _current_mesh
    _current_mesh = mesh
    for i, name in enumerate(mesh.axis_names):
        _rings.setdefault(i, name)
    return mesh


def get_mesh():
    return _current_mesh


def register_ring(ring_id: int, axis_name: str):
    _rings[ring_id] = axis_name


def ring_axis(ring_id: int) -> Optional[str]:
    return _rings.get(ring_id)


def reset():
    global _current_mesh
    _current_mesh = None
    _rings.clear()


def ring_group(ring_id):
    """(group, size, index) of ring ``ring_id`` on the current mesh, or
    None where the ring is a single participant (no mesh, no such axis,
    or an axis of one rank)."""
    axis = ring_axis(ring_id)
    mesh = _current_mesh
    if axis is None or mesh is None or axis not in mesh.shape:
        return None
    if mesh.shape[axis] == 1 or mesh.group(axis) is None:
        return None
    return mesh.group(axis), mesh.shape[axis], mesh.axis_index(axis)


# ---------------------------------------------------------------------------
# collectives, counted by route
# ---------------------------------------------------------------------------

def _route(t):
    return "nccl" if backend() == "nccl" else "gloo"


def _count(op, route, nbytes):
    with _route_lock:
        c = _route_counts.setdefault((op, route), [0, 0])
        c[0] += 1
        c[1] += int(nbytes)


def routes() -> dict:
    """{"<collective> <route>": {"calls": n, "bytes": b}} so far."""
    with _route_lock:
        return {f"{op} {route}": {"calls": c[0], "bytes": c[1]}
                for (op, route), c in sorted(_route_counts.items())}


def reset_routes():
    with _route_lock:
        _route_counts.clear()


_REDUCE = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def collective(op, t, group, size, **kw):
    """One collective over ``group`` (``size`` ranks) on tensor ``t``;
    returns a new tensor, ``t`` is left as it is.  A group of None is a
    world of one (route ``single``); a group of one rank still calls the
    backend.

    ``all_reduce`` (``reduce``: sum, max, min), ``broadcast`` (``src``:
    the root's index in the group), ``all_gather`` (the ranks' tensors
    stacked on a new dim 0), ``reduce_scatter`` (``t`` [size*k, ...] ->
    the sum of the ranks' k rows at this rank's index), ``all_to_all``
    (``t`` [size, ...]: row j goes to rank j; the result's row i came
    from rank i).  A ``meta`` tensor (shape inference) gets the result's
    shape and no call."""
    t = t.contiguous()
    if group is None:
        _count(op, "single", 0)
        if op == "all_gather":
            return t.unsqueeze(0).clone()
        return t.clone()
    if t.device.type == "meta":
        # shape inference (Block.append_op): the result's shape, no call
        if op == "all_gather":
            return t.unsqueeze(0).expand((size,) + tuple(t.shape))
        if op == "reduce_scatter":
            return t[:t.shape[0] // size]
        return t.clone()
    _count(op, _route(t), t.numel() * t.element_size())
    if op == "all_reduce":
        out = t.clone()
        dist.all_reduce(out, op=getattr(dist.ReduceOp,
                                        _REDUCE[kw.get("reduce", "sum")]),
                        group=group)
        return out
    if op == "broadcast":
        out = t.clone()
        dist.broadcast(out, src=dist.get_global_rank(group, kw["src"])
                       if group is not dist.group.WORLD else kw["src"],
                       group=group)
        return out
    if op == "all_gather":
        flat = t.reshape(-1)
        out = torch.empty((size * flat.numel(),), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, flat, group=group)
        return out.view((size,) + tuple(t.shape))
    if op == "reduce_scatter":
        shape = (t.shape[0] // size,) + tuple(t.shape[1:])
        out = torch.empty((t.numel() // size,), dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, t.reshape(-1), group=group)
        return out.view(shape)
    if op == "all_to_all":
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out
    raise ValueError(f"unknown collective {op!r}")


def barrier(group=None):
    """A barrier over ``group`` (the world by default); nothing on a
    world of one."""
    if not is_initialized():
        return
    _count("barrier", _route(None), 0)
    if backend() == "nccl":
        dist.barrier(group=group, device_ids=[default_device_id()])
    else:
        dist.barrier(group=group)


# ---------------------------------------------------------------------------
# data parallelism: the thread's step and its differentiable collectives
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def data_parallel(mesh, axis):
    """Within: the thread's ops run one data-parallel step over ``axis``
    of ``mesh``; ``batch_group`` names its group."""
    prev = getattr(_local, "dp", None)
    group = mesh.group(axis) if mesh is not None else None
    size = mesh.shape[axis] if mesh is not None else 1
    _local.dp = (group, size) if group is not None and size > 1 else None
    try:
        yield
    finally:
        _local.dp = prev


def batch_group():
    """(group, size) of the data-parallel step this thread runs, or None
    outside one (or over a single rank): batch statistics are then the
    local batch's."""
    return getattr(_local, "dp", None)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the adjoint sums the cotangents over it."""

    @staticmethod
    def forward(ctx, t, group, size):
        ctx.group, ctx.size = group, size
        return collective("all_reduce", t, group, size)

    @staticmethod
    def backward(ctx, g):
        return collective("all_reduce", g, ctx.group, ctx.size), None, None


class _AllGatherStacked(torch.autograd.Function):
    """The ranks' tensors on a new dim 0; the adjoint of this rank's
    tensor is its row of the cotangents summed over the group."""

    @staticmethod
    def forward(ctx, t, group, size, index):
        ctx.group, ctx.size, ctx.index = group, size, index
        return collective("all_gather", t, group, size)

    @staticmethod
    def backward(ctx, g):
        total = collective("all_reduce", g, ctx.group, ctx.size)
        return total[ctx.index], None, None, None


def all_reduce_sum(t, group, size):
    """Differentiable sum of ``t`` over ``group``."""
    return _AllReduceSum.apply(t, group, size)


def all_gather_stacked(t, group, size):
    """Differentiable [size, ...] stack of the ranks' ``t``."""
    index = dist.get_group_rank(group, dist.get_rank()) \
        if group is not dist.group.WORLD else dist.get_rank()
    return _AllGatherStacked.apply(t, group, size, index)


def make_hybrid_mesh(dcn_axes, ici_axes, devices=None):
    raise NotImplementedError(
        "parallel.env.make_hybrid_mesh is not ported yet (ROADMAP Queue 1 "
        "item 5, parallel/gspmd.py)")


def shard_map(f, mesh, in_specs, out_specs, check_rep=False):
    raise NotImplementedError(
        "parallel.env.shard_map is not ported yet (ROADMAP Queue 1 item 5, "
        "parallel/gspmd.py): one process drives one device, and a "
        "program's collectives run over the mesh's process groups")

