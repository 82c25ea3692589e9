#!/usr/bin/env python3
"""Times the port's conv kernels (#5 conv_epilogue, #6 conv_stats) of one
source tree on one NVIDIA GPU, by CUDA-graph replay and by CUDA events.

    python3 tools/time_conv.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``paddle_tpu_torch`` is timed (default:
this one), so two versions of the kernels are compared on one card in
one call, in turns: ``--root old``, then this tree twice, then ``old``
again.  The timers are ``chip_smoke.py``'s.  Shapes: every distinct conv
of the ResNet-50 training step (the stem among them) at batch 128 in
bf16, as ``chip_smoke.py`` reads them from the built program, with how
often each runs a step; cuDNN's channels-last ``F.conv2d`` is timed
beside them.  Prints one JSON line per shape, one with the sums over a
step, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 128
ITERS = 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_conv: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import (build_resnet_program, card_line, conv_operands,
                            cuda_ms, graph_ms, resnet_conv_shapes)

    sys.path.insert(0, os.path.abspath(args.root))
    from paddle_tpu_torch.ops import conv_epilogue as cep

    label = args.label or os.path.abspath(args.root)
    device = torch.device("cuda", 0)
    convs, _ = resnet_conv_shapes(build_resnet_program("conv_bn_stats")[1])
    rng = np.random.RandomState(0)
    totals = {}
    for (h, w, cin, cout, k, s, p), count in sorted(convs.items()):
        x, wt = conv_operands(rng, device, BATCH, h, w, cin, cout, k,
                              "bfloat16")
        pad = ((p, p), (p, p))
        xn = x.permute(0, 3, 1, 2)
        w_cl = wt.contiguous(memory_format=torch.channels_last)
        calls = {
            "conv_epilogue": lambda: cep.conv_epilogue_kernel(
                x, wt, None, None, (s, s), pad),
            "conv_stats": lambda: cep.conv_stats_kernel(x, wt, None, (s, s),
                                                        pad),
            "cudnn": lambda: F.conv2d(xn, w_cl, stride=s, padding=p),
        }
        row = {"label": label, "shape": [BATCH, h, w, cin, cout, k, s, p],
               "per_step": count}
        for name, fn in calls.items():
            for timer, key in ((graph_ms, "ms"), (cuda_ms, "event_ms")):
                ms = timer(fn, ITERS)
                row[f"{name}_{key}"] = ms
                totals[f"{name}_{key}"] = totals.get(f"{name}_{key}", 0.0) \
                    + count * ms
        print("conv times " + json.dumps(row), flush=True)
        del x, wt, xn, w_cl, calls
        torch.cuda.empty_cache()
    print("conv times per step " + json.dumps({"label": label, **totals}),
          flush=True)
    print(f"device: {card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
