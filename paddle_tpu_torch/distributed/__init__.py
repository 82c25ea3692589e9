"""Distributed control plane of the port.

Counterpart of ``paddle_tpu/distributed/``: the socket RPC transport
(``rpc``) and its HTTP framing (``http_transport``, chosen by
``PADDLE_TPU_RPC_TRANSPORT=http``), the wire both packages share, and
the seeded fault injector (``faultinject``).  The parameter-server ops
that ride on them are ``ops/ps_ops.py``.  On top of them: the Downpour
CTR path (``downpour.py``'s ``DownpourSGD`` and ``downpour_worker.py``'s
``DownpourRunner``), PS role arithmetic (``ps_instance.py``) and the
elastic crash-resume loop (``elastic.py``'s ``ElasticTrainer``); the
async ``Communicator`` is ``communicator.py`` beside this package and
fleet's parameter-server mode ``fleet/``.  ``collective_server.py``'s
monomer gather (``CollectiveServer``, ``CollectiveClient``) rides the same
transport; the collective mode's process group is ``parallel/env.py``.
"""

from paddle_tpu_torch.distributed.collective_server import (  # noqa: F401
    CollectiveClient, CollectiveServer)

from paddle_tpu_torch.distributed.elastic import ElasticTrainer  # noqa: F401
from paddle_tpu_torch.distributed.faultinject import (  # noqa: F401
    FaultInjector, FaultPlan)
from paddle_tpu_torch.distributed.rpc import (  # noqa: F401
    BarrierTimeoutError, CircuitOpenError, RPCClient, RPCDeadlineExceeded,
    RPCServer)
