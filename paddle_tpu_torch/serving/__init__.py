"""Serving of the torch port: the batching inference server over
Predictor replicas, and LLM decode through ``DecodeServer``.

Counterpart of ``paddle_tpu/serving``.  Ported:

  admission.py      bounded queue, typed shedding, per-tenant quotas,
                    the exactly-once Request future, request-id
                    accounting
  batcher.py        shape-bucketed dynamic batching, pad-to-bucket,
                    the compile-once bucket cache (on the card one
                    captured CompiledProgram key a bucket), max-wait
                    timer
  replica_pool.py   N Predictor replicas, health probes, per-replica
                    circuit breakers, failover/requeue, the per-replica
                    drain and the Predictor swap
  server.py         InferenceServer / ServingConfig / drain()
  registry.py       ModelRegistry: named, versioned programs riding the
                    ProgramDesc serialization, deduped by program
                    fingerprint, prewarmed (every bucket captured)
                    before they take traffic
  fleet.py          RolloutController — zero-downtime rolling version
                    swaps through the per-replica drain with
                    burn-triggered rollback — and SLOAutoscaler, which
                    sizes the ReplicaPool from the burn-rate signal of
                    ``observability.slo`` (hysteresis + cooldown)
  decode_engine.py  continuous decode batching: ``DecodeServer`` runs
                    iteration-level batching of LLM decode over paged
                    KV-caches and ``flash_decode``, with chunked prefill
                    (``prefill_chunk``), copy-on-write prefix sharing
                    (``kv_share``) and lossless speculative decoding
                    (``spec_k``)

    from paddle_tpu_torch import inference, serving

    factory = lambda i: inference.create_predictor(
        inference.Config(model_dir))                # on the card
    with serving.InferenceServer(
            factory, serving.ServingConfig(n_replicas=2)) as srv:
        out = srv.infer({"x": batch})               # typed errors on shed

``Config.disable_gpu()`` (``DecodeConfig(device="cpu")``,
``ModelRegistry(configure=lambda c: c.disable_gpu())``) runs on the
CPU.  Not ported yet, each raising ``NotImplementedError`` that names
its ROADMAP Queue 1 item: mesh-sliced replicas and
``replicate_predictor_params`` (item 5); the fleet collector of both
servers (``collector``, item 4.3); ``DecodeServer``'s
``disagg_prefill`` (item 4.4).  ``metrics_port`` mounts the ``/metrics``
exporter on either server.
"""

from paddle_tpu_torch.serving.admission import (  # noqa: F401
    AdmissionController,
    DeadlineExpiredError,
    HandoffError,
    OverloadedError,
    QuotaExceededError,
    ReplicaFailedError,
    Request,
    ServingError,
    ShutdownError,
    TenantQuota,
)
from paddle_tpu_torch.serving.batcher import (  # noqa: F401
    Batch,
    ShapeBucketBatcher,
    default_buckets,
    signature_of,
)
from paddle_tpu_torch.serving.replica_pool import (  # noqa: F401
    MSG_HEALTH,
    MSG_INFER,
    Replica,
    ReplicaKilled,
    ReplicaPool,
    ReplyLost,
    replicate_predictor_params,
)
from paddle_tpu_torch.serving.decode_engine import (  # noqa: F401
    MSG_DECODE,
    DecodeConfig,
    DecodeServer,
    TinyDecodeLM,
)
from paddle_tpu_torch.serving.server import (  # noqa: F401
    InferenceServer,
    ServingConfig,
)
from paddle_tpu_torch.serving.registry import (  # noqa: F401
    ManifestMismatchError,
    ModelNotFoundError,
    ModelRegistry,
    ModelVersion,
    PrewarmFailedError,
    RegistryError,
    VersionNotFoundError,
)
from paddle_tpu_torch.serving.fleet import (  # noqa: F401
    RolloutController,
    RolloutError,
    RolloutResult,
    SLOAutoscaler,
)

__all__ = [
    "AdmissionController", "Batch", "DeadlineExpiredError",
    "DecodeConfig", "DecodeServer", "HandoffError", "InferenceServer",
    "MSG_DECODE", "MSG_HEALTH", "MSG_INFER", "ManifestMismatchError",
    "ModelNotFoundError", "ModelRegistry", "ModelVersion",
    "OverloadedError", "PrewarmFailedError", "QuotaExceededError",
    "RegistryError", "Replica", "ReplicaFailedError", "ReplicaKilled",
    "ReplicaPool", "ReplyLost", "Request", "RolloutController",
    "RolloutError", "RolloutResult", "SLOAutoscaler", "ServingConfig",
    "ServingError", "ShapeBucketBatcher", "ShutdownError", "TenantQuota",
    "TinyDecodeLM", "VersionNotFoundError", "default_buckets",
    "replicate_predictor_params", "signature_of",
]
