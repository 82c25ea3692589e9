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
fleet's parameter-server mode ``fleet/``.  The collective server and the
collective mode are not ported yet (ROADMAP Queue 1 item 5).
"""

from paddle_tpu_torch.distributed.elastic import ElasticTrainer  # noqa: F401
from paddle_tpu_torch.distributed.faultinject import (  # noqa: F401
    FaultInjector, FaultPlan)
from paddle_tpu_torch.distributed.rpc import (  # noqa: F401
    BarrierTimeoutError, CircuitOpenError, RPCClient, RPCDeadlineExceeded,
    RPCServer)
