"""Collective ops (the ``c_*`` family, ``all_to_all``, ``allreduce``,
``broadcast``).

Counterpart of ``paddle_tpu/ops/collective.py``: the same 14 op types,
slots, attrs and defaults.  The ``ring_id`` attr names a mesh axis
(``parallel/env.py``'s ring registry) and through it a process group.

The JAX ops lower to XLA collectives inside ``shard_map``/``pjit`` and
are the identity outside them, so a transpiled program that the JAX
package runs in one process never reduces.  Here one process drives one
device, and an op performs its collective whenever its ring's group has
more than one rank: the reference Fluid's meaning.  On a ring of a
single participant (no mesh, no axis, an axis of one rank) every op is
the identity, as in the JAX package.  ``prod`` is exact for negatives and
zeros: a gather, then a local product.  ``c_comm_init`` and
``c_gen_nccl_id`` do nothing: the process group comes up from the
``PADDLE_*`` contract (``parallel.env.init_parallel_env``).

Reference parity: operators/collective/ c_allreduce_op.h,
c_allgather_op.cc, c_reducescatter_op.cc, c_broadcast_op.cc,
c_comm_init_op.cc, c_gen_nccl_id_op.cc; distributed_ops/allreduce_op.cc
and broadcast_op.cc.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.parallel import env

# op types whose compute issues a collective whenever their group has
# more than one rank (sync_batch_norm's too): the compiled path keeps them
# out of a CUDA graph where the backend cannot be captured (gloo)
COLLECTIVE_OPS = frozenset((
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_allgather", "c_reducescatter", "c_broadcast",
    "all_to_all", "allreduce", "broadcast", "sync_batch_norm",
    "sync_batch_norm_grad"))


def _allreduce(x, ring, how):
    group, size, _ = ring
    if how == "prod":
        return torch.prod(env.collective("all_gather", x, group, size),
                          dim=0)
    return env.collective("all_reduce", x, group, size, reduce=how)


def _register_allreduce(name, how):
    @register_op(name, inputs=("X",), outputs=("Out",),
                 attrs={"ring_id": 0, "use_calc_stream": True},
                 differentiable=False, in_place={"Out": "X"})
    def _fn(ins, attrs, device, how=how):
        ring = env.ring_group(attrs["ring_id"])
        if ring is None:
            return {"Out": ins["X"]}  # single-participant ring
        return {"Out": _allreduce(ins["X"], ring, how)}
    return _fn


_register_allreduce("c_allreduce_sum", "sum")
_register_allreduce("c_allreduce_max", "max")
_register_allreduce("c_allreduce_min", "min")
_register_allreduce("c_allreduce_prod", "prod")


@register_op("c_allgather", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": 0, "nranks": 1}, differentiable=False)
def c_allgather(ins, attrs, device):
    """The ranks' X concatenated on dim 0, in rank order."""
    ring = env.ring_group(attrs["ring_id"])
    x = ins["X"]
    if ring is None:
        return {"Out": x}
    group, size, _ = ring
    out = env.collective("all_gather", x, group, size)
    return {"Out": out.reshape((size * x.shape[0],) + tuple(x.shape[1:]))}


@register_op("c_reducescatter", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": 0, "nranks": 1}, differentiable=False)
def c_reducescatter(ins, attrs, device):
    """X's dim 0 split in as many blocks as ranks; rank i gets block i
    summed over the ranks."""
    ring = env.ring_group(attrs["ring_id"])
    if ring is None:
        return {"Out": ins["X"]}
    group, size, _ = ring
    return {"Out": env.collective("reduce_scatter", ins["X"], group, size)}


@register_op("c_broadcast", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": 0, "root": 0}, differentiable=False)
def c_broadcast(ins, attrs, device):
    ring = env.ring_group(attrs["ring_id"])
    if ring is None:
        return {"Out": ins["X"]}
    group, size, _ = ring
    return {"Out": env.collective("broadcast", ins["X"], group, size,
                                  src=int(attrs["root"]))}


@register_op("c_sync_calc_stream", inputs=("X",), outputs=("Out",),
             differentiable=False)
def c_sync_calc_stream(ins, attrs, device):
    # a collective here is ordered on the caller's stream already
    return {"Out": ins["X"]}


@register_op("c_sync_comm_stream", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": 0}, differentiable=False)
def c_sync_comm_stream(ins, attrs, device):
    return {"Out": ins["X"]}


@register_op("c_comm_init", inputs=(), outputs=(),
             attrs={"ring_id": 0, "nranks": 1, "rank": 0, "device_id": 0},
             differentiable=False, host_only=True)
def c_comm_init(ins, attrs, device):
    return {}


@register_op("c_gen_nccl_id", inputs=(), outputs=("Out",),
             attrs={"rank": 0, "endpoint": "", "other_endpoints": []},
             differentiable=False, host_only=True)
def c_gen_nccl_id(ins, attrs, device):
    return {"Out": torch.zeros((1,), dtype=torch.int32, device=device)}


@register_op("all_to_all", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": 0, "split_axis": 0, "concat_axis": 0},
             differentiable=False)
def all_to_all(ins, attrs, device):
    """``lax.all_to_all(tiled=True)``: X split on ``split_axis`` in as
    many blocks as ranks, block j sent to rank j; the blocks received
    concatenated on ``concat_axis`` in rank order."""
    ring = env.ring_group(attrs["ring_id"])
    x = ins["X"]
    if ring is None:
        return {"Out": x}
    group, size, _ = ring
    blocks = torch.stack(torch.chunk(x, size, dim=attrs["split_axis"]))
    got = env.collective("all_to_all", blocks, group, size)
    return {"Out": torch.cat(list(got.unbind(0)),
                             dim=attrs["concat_axis"])}


_REDUCE_TYPES = ("sum", "max", "min", "prod")


@register_op("allreduce", inputs=("X",), outputs=("Out",),
             attrs={"reduce_type": 0, "sync_mode": False},
             differentiable=False, in_place={"Out": "X"})
def allreduce(ins, attrs, device):
    """distributed_ops/allreduce_op.cc: reduce_type 0..3 = sum, max,
    min, prod over ring 0."""
    ring = env.ring_group(0)
    if ring is None:
        return {"Out": ins["X"]}
    rt = int(attrs["reduce_type"])
    if not 0 <= rt < len(_REDUCE_TYPES):
        raise ValueError(f"unknown reduce_type {rt}")
    return {"Out": _allreduce(ins["X"], ring, _REDUCE_TYPES[rt])}


@register_op("broadcast", inputs=("X",), outputs=("Out",),
             attrs={"root": 0, "sync_mode": False},
             differentiable=False, in_place={"Out": "X"})
def broadcast_op(ins, attrs, device):
    """distributed_ops/broadcast_op.cc: every participant takes rank
    ``root``'s value (of ring 0)."""
    ring = env.ring_group(0)
    if ring is None:
        return {"Out": ins["X"]}
    group, size, _ = ring
    return {"Out": env.collective("broadcast", ins["X"], group, size,
                                  src=int(attrs["root"]))}
