"""Serving of the torch port: LLM decode through ``DecodeServer``.

Counterpart of ``paddle_tpu/serving``.  Ported so far:

  admission.py      bounded queue, typed shedding, the exactly-once
                    Request future, request-id accounting
  replica_pool.py   the replica failure types (``ReplicaKilled``,
                    ``ReplyLost``)
  decode_engine.py  continuous decode batching: ``DecodeServer`` runs
                    iteration-level batching of LLM decode over paged
                    KV-caches and ``flash_decode``, with chunked prefill
                    (``prefill_chunk``), copy-on-write prefix sharing
                    (``kv_share``) and lossless speculative decoding
                    (``spec_k``)

    from paddle_tpu_torch import serving

    srv = serving.DecodeServer(config=serving.DecodeConfig(
        max_batch=64, page_size=128)).start()     # on the card
    tokens = srv.submit(prompt_ids).result(timeout=60.0)[0]
    srv.stop()

``DecodeConfig(device="cpu")`` runs on the CPU.  The batching inference
server, the replica pool, the model registry, the fleet controls and
the disaggregated prefill tier are the serving-tier slice's, not ported
yet.
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
from paddle_tpu_torch.serving.replica_pool import (  # noqa: F401
    ReplicaKilled,
    ReplyLost,
)
from paddle_tpu_torch.serving.decode_engine import (  # noqa: F401
    MSG_DECODE,
    DecodeConfig,
    DecodeServer,
    TinyDecodeLM,
)
