#!/usr/bin/env python3
"""Times the port's RPC transport the way a parameter-server trainer
uses it: ``send_var`` then ``get_var`` of one set of float32 arrays (by
default the Transformer-base LM's parameter shapes at full width, about
207 MB) against a server in this process, over the socket or the HTTP
framing.

    python3 tools/time_rpc_wire.py [--transport socket|http] [--reps 3]

Prints one line a repetition: the seconds of all the sends and of all
the gets, and the MB each moved.  Host time only (no device is used;
the parameters' shapes come from building the LM's program, whose
parameters are never initialised).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the Transformer-base LM of chip_smoke.py (bench.py's widths)
LM = dict(vocab_size=32000, max_len=512, d_model=512, n_head=8,
          d_inner=2048, n_layer=6, dropout_rate=0.0, is_test=False)


def lm_shapes():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        transformer_encoder_model(**LM)
    return [tuple(p.shape) for p in main.all_parameters()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--transport", choices=("socket", "http"),
                    default="socket")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    os.environ["PADDLE_TPU_RPC_TRANSPORT"] = args.transport
    from paddle_tpu_torch.distributed import rpc

    store = {}
    srv = rpc.make_rpc_server("127.0.0.1:0").start()
    srv.register_handler("send_var",
                         lambda p: store.__setitem__(p[0], p[1]))
    srv.register_handler("get_var", lambda p: store[p[0]])
    client = rpc.make_rpc_client()
    rng = np.random.RandomState(0)
    arrays = [rng.rand(*s).astype(np.float32) for s in lm_shapes()]
    mb = sum(a.nbytes for a in arrays) / 1e6
    try:
        for rep in range(args.reps):
            t0 = time.perf_counter()
            for i, a in enumerate(arrays):
                client.send_var(srv.endpoint, f"w{i}", a, trainer_idx=0)
            t1 = time.perf_counter()
            for i in range(len(arrays)):
                client.get_var(srv.endpoint, f"w{i}", trainer_idx=0)
            t2 = time.perf_counter()
            print(f"{args.transport} rep {rep}: send {t1 - t0:.3f} s, "
                  f"get {t2 - t1:.3f} s, {mb:.1f} MB each way, "
                  f"{len(arrays)} arrays", flush=True)
    finally:
        client.close()
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
