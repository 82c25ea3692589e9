#!/usr/bin/env python3
"""Times the port's flash-attention forward kernel of one source tree on
one NVIDIA GPU, by CUDA-graph replay and by CUDA events, beside
PyTorch's scaled_dot_product_attention.

    python3 tools/time_flash_fwd.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``paddle_tpu_torch`` is timed (default:
this one), so two versions of the kernel are compared on one card in
one call, in turns: ``--root old``, then this tree twice, then ``old``
again.  The timers are ``chip_smoke.py``'s.  Shapes: the LM's f32 step
and serving request (``[8,8,512,64]`` f32, and the same at d 128) and
its AMP step (``[32,8,512,64]`` bf16), causal over permuted
``[B,T,H,D]`` views.  Prints one JSON line per shape, then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, H, T, D, dtype)
SHAPES = [(8, 8, 512, 64, "float32"), (8, 8, 512, 128, "float32"),
          (32, 8, 512, 64, "bfloat16")]
ITERS = 20


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_flash_fwd: no CUDA device is available", file=sys.stderr)
        return 2
    mm = torch.backends.cuda.matmul
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = False
    sys.path.insert(0, REPO)
    from chip_smoke import card_line, cuda_ms, graph_ms

    sys.path.insert(0, os.path.abspath(args.root))
    from paddle_tpu_torch.ops import flash_attention as fa

    device = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    for b, h, t, d, dtype in SHAPES:
        def make():
            x = torch.from_numpy(rng.standard_normal(
                (b, t, h, d)).astype(np.float32))
            return x.to(device, getattr(torch, dtype)).permute(0, 2, 1, 3)

        q, k, v = make(), make(), make()
        scale = 1.0 / math.sqrt(d)
        calls = {
            "kernel": lambda: fa.flash_attention_fwd(q, k, v, True, scale),
            "sdpa": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale),
        }
        row = {"label": args.label or os.path.abspath(args.root),
               "shape": [b, h, t, t, d], "dtype": dtype, "causal": True}
        for name, fn in calls.items():
            row[f"{name}_ms"] = graph_ms(fn, ITERS)
            row[f"{name}_event_ms"] = cuda_ms(fn, ITERS)
        print("flash fwd times " + json.dumps(row), flush=True)
        del q, k, v, calls
        torch.cuda.empty_cache()
    print(f"device: {card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
