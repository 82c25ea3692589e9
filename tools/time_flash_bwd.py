#!/usr/bin/env python3
"""Times the port's flash-attention backward kernels (dq, dkv) of one
source tree on one NVIDIA GPU, by CUDA-graph replay and by CUDA events.

    python3 tools/time_flash_bwd.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``paddle_tpu_torch`` is timed (default:
this one), so two versions of the kernels are compared on one card in
one call, in turns: ``--root old``, then this tree twice, then ``old``
again.  The timers are ``chip_smoke.py``'s.  Shapes: the LM's AMP step
(``[32,8,512,64]`` bf16), its f32 step (``[8,8,512,64]``, and the same
at d 128) and the bench's two 32768-token long-context shapes (bf16,
d 64 and 128), all causal over permuted ``[B,T,H,D]`` views.  Prints one JSON line per
shape, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, H, T, D, dtype, graph-replay and event iterations)
SHAPES = [(32, 8, 512, 64, "bfloat16", 10),
          (8, 8, 512, 64, "float32", 10),
          (8, 8, 512, 128, "float32", 10),
          (1, 8, 32768, 64, "bfloat16", 2),
          (1, 8, 32768, 128, "bfloat16", 2)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_flash_bwd: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import card_line, cuda_ms, graph_ms

    sys.path.insert(0, os.path.abspath(args.root))
    from paddle_tpu_torch.ops import flash_attention as fa

    device = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    for b, h, t, d, dtype, iters in SHAPES:
        def make():
            x = torch.from_numpy(rng.standard_normal(
                (b, t, h, d)).astype(np.float32))
            return x.to(device, getattr(torch, dtype)).permute(0, 2, 1, 3)

        q, k, v, do = make(), make(), make(), make()
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
        prepared = fa._bwd_prepare(q, k, v, o, lse, do, None)
        if len(prepared) == 3:          # a tree from before the aligned copies
            prepared = (q, k, v) + tuple(prepared)
        q, k, v, do, lse, delta = prepared
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        calls = {
            "dq": lambda: fa._bwd_kernel("dq", q, k, v, do, lse, delta,
                                         (dq,), True, scale),
            "dkv": lambda: fa._bwd_kernel("dkv", q, k, v, do, lse, delta,
                                          (dk, dv), True, scale),
        }
        row = {"label": args.label or os.path.abspath(args.root),
               "shape": [b, h, t, t, d], "dtype": dtype, "causal": True}
        for name, fn in calls.items():
            row[f"{name}_ms"] = graph_ms(fn, iters)
            row[f"{name}_event_ms"] = cuda_ms(fn, iters)
        print("flash bwd times " + json.dumps(row), flush=True)
        del q, k, v, do, o, lse, delta, dq, dk, dv, prepared
        torch.cuda.empty_cache()
    print(f"device: {card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
