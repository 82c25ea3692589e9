"""Multi-process launcher.

Counterpart of ``paddle_tpu/launch.py``: the same arguments and the same
``PADDLE_*`` environment for each child (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_COORDINATOR_ENDPOINT``,
``FLAGS_selected_gpus``), from which ``fleet.init()`` brings
``torch.distributed`` up.  The port drives one device a process, so a
host of N cards takes ``--nproc_per_node N``; the default stays 1, as in
the JAX package.  SIGINT and SIGTERM are passed on to every child, and the
launcher then exits with 128 + the signal once they ended; otherwise with
the last non-zero exit code of its children.

Reference parity: python/paddle/distributed/launch.py:132.

Usage:  python -m paddle_tpu_torch.launch --nproc_per_node 2 \\
            --started_port 6170 train.py [args...]
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.launch")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes per node: one a device")
    p.add_argument("--node_ips", type=str, default="127.0.0.1",
                   help="comma-separated node ips")
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch(args):
    ips = args.node_ips.split(",")
    nproc = args.nproc_per_node
    endpoints = []
    for ip in ips:
        for i in range(nproc):
            endpoints.append(f"{ip}:{args.started_port + i}")
    world = args.nnodes * nproc

    procs = []
    for local in range(nproc):
        rank = args.node_rank * nproc + local
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_COORDINATOR_ENDPOINT": endpoints[0],
            "FLAGS_selected_gpus": str(local),   # reference-compat
        })
        cmd = [sys.executable, args.training_script] \
            + args.training_script_args
        procs.append(subprocess.Popen(cmd, env=env))

    received = []

    def _pass_on(sig, frame):
        # no wait here: the main loop's wait holds the children's locks
        received.append(sig)
        for pr in procs:
            if pr.poll() is None:
                pr.send_signal(sig)

    signal.signal(signal.SIGINT, _pass_on)
    signal.signal(signal.SIGTERM, _pass_on)

    code = 0
    for pr in procs:
        pr.wait()
        if pr.returncode != 0:
            code = pr.returncode
    return 128 + received[0] if received else code


def main(argv=None):
    args = _parse_args(argv)
    sys.exit(launch(args))


if __name__ == "__main__":
    main()
