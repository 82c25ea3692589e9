"""Parallelism on ``torch.distributed``: the rank mesh and ZeRO's rules.

Counterpart of ``paddle_tpu/parallel/``.  Ported so far: ``env`` (the
mesh, the ring registry, the process group and its collectives),
``zero`` and ``gspmd`` (``MeshPlan`` and the annotation passes, which
``CompiledProgram`` runs through ``core/sharding.py``).
``ring_attention``, ``ulysses``, ``pipeline``, ``moe`` and ``dgc`` wait
(ROADMAP Queue 1 item 5).

Reference parity: ParallelExecutor multi-device DP + NCCL
(framework/parallel_executor.cc) -> ``CompiledProgram.with_data_parallel``
over the mesh's data axis; NCCLContextMap ring ids -> mesh axis names
(``env.ring_axis``).
"""

from paddle_tpu_torch.parallel import env  # noqa: F401
from paddle_tpu_torch.parallel import gspmd  # noqa: F401
from paddle_tpu_torch.parallel import zero  # noqa: F401
from paddle_tpu_torch.parallel.env import (  # noqa: F401
    get_mesh, make_hybrid_mesh, make_mesh, register_ring, ring_axis,
    set_mesh, shard_map)
from paddle_tpu_torch.parallel.gspmd import (  # noqa: F401
    MeshPlan, annotate_tp_inference, annotate_tp_transformer, annotate_var,
    annotate_zero3, carve_slices, partition_spec_of, tag_attention_ops)
from paddle_tpu_torch.parallel.zero import (  # noqa: F401
    PartitionSpec, collect_optimizer_state, is_optimizer_accumulator,
    zero_sharding_rules)
