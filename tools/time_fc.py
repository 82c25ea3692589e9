#!/usr/bin/env python3
"""Times the port's fc_epilogue kernel of one source tree on one NVIDIA
GPU, by CUDA-graph replay and by CUDA events, beside the flag-off chain
(cuBLAS product, then each add and the act) and torch.addmm.

    python3 tools/time_fc.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``paddle_tpu_torch`` is timed (default:
this one), so two versions of the kernel are compared on one card in
one call, in turns: ``--root old``, then this tree twice, then ``old``
again.  The timers and shapes are ``chip_smoke.py``'s: the AMP step's
three calls a layer (``FC_MAIN``: out-proj, fc1, fc2 at M = 32 * 512,
bf16).  Prints one JSON line per shape (with the path the call took,
where the tree counts paths, and TFLOP/s), one with the sums over a
layer, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 20


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_fc: no CUDA device is available", file=sys.stderr)
        return 2
    mm = torch.backends.cuda.matmul
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = False
    sys.path.insert(0, REPO)
    from chip_smoke import (AMP_BATCH, FC_MAIN, MODEL, card_line, cuda_ms,
                            fc_operands, graph_ms)

    sys.path.insert(0, os.path.abspath(args.root))
    from paddle_tpu_torch.ops import epilogue as ep

    label = args.label or os.path.abspath(args.root)
    device = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    m = AMP_BATCH * MODEL["max_len"]
    totals = {}
    for name, k, n, attr in FC_MAIN:
        act = ep.EpilogueSpec.from_attr(attr).act
        x, w, b, r = fc_operands(rng, device, m, k, n, attr, "bfloat16")
        addend = r if b is None else b
        by_path = dict(getattr(ep.fc_epilogue, "launches_by_path", {}))
        ep.fc_epilogue_kernel(x, w, b, r, act)
        path = [p for p, c in getattr(ep.fc_epilogue, "launches_by_path",
                                      {}).items() if c != by_path.get(p)]
        calls = {
            "kernel": lambda: ep.fc_epilogue_kernel(x, w, b, r, act),
            "chain": lambda: ep._fc_reference(x, w, b, r, act, False),
            "addmm": lambda: torch.addmm(addend, x, w),
        }
        row = {"label": label, "name": name, "shape": [m, k, n],
               "epilogue": attr, "path": path[0] if path else None}
        for call, fn in calls.items():
            for timer, key in ((graph_ms, "ms"), (cuda_ms, "event_ms")):
                ms = timer(fn, ITERS)
                row[f"{call}_{key}"] = ms
                totals[f"{call}_{key}"] = totals.get(f"{call}_{key}", 0.0) \
                    + ms
        row["tflops"] = 2.0 * m * k * n / row["kernel_ms"] / 1e9
        print("fc times " + json.dumps(row), flush=True)
        del x, w, b, r, addend, calls
        torch.cuda.empty_cache()
    print("fc times per layer " + json.dumps({"label": label, **totals}),
          flush=True)
    print(f"device: {card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
