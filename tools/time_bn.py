#!/usr/bin/env python3
"""Times the port's bn_apply kernel of one source tree on one NVIDIA GPU,
by CUDA-graph replay and by CUDA events, at every batch-norm shape of
the ResNet-50 conv_bn_stats training step at batch 128 (phase 8's
shapes of ``chip_smoke.py``), beside F.batch_norm + add + relu, and
checks that two trees' outputs are equal.

    python3 tools/time_bn.py [--root DIR] [--label NAME]
                             [--save FILE | --against FILE]

``--root`` is the checkout whose ``paddle_tpu_torch`` is timed (default:
this one), so two versions of the kernel are compared on one card in one
call, in turns.  Inputs are made from the same seed in every run;
``--save`` writes each shape's output to FILE, and ``--against`` loads
such a file and fails unless every output is ``torch.equal`` to it.
Prints one JSON line per shape (with the launches a step, the bound and
its share), one with the sums over a step weighted by launches, then the
card's name and power limit.
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
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--save", default=None)
    group.add_argument("--against", default=None)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_bn: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import (RN_BATCH, bn_times, bound_of,
                            build_resnet_program, card_line, cuda_ms,
                            graph_ms, resnet_conv_shapes)

    sys.path.insert(0, os.path.abspath(args.root))
    from paddle_tpu_torch.ops import conv_epilogue as cep

    label = args.label or os.path.abspath(args.root)
    device = torch.device("cuda", 0)
    _, bns = resnet_conv_shapes(build_resnet_program("conv_bn_stats")[1])
    rng = np.random.RandomState(0)

    def t(shape, dtype="bfloat16"):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, getattr(torch, dtype))

    saved = {} if args.save else None
    want = torch.load(args.against) if args.against else None
    totals, equal = {}, True
    for (oh, ow, c, has_res, relu), count in sorted(bns.items()):
        shape = (RN_BATCH, oh, ow, c)
        y = t(shape)
        res = t(shape) if has_res else None
        mean, scale, shift = (t((c,), "float32") for _ in range(3))
        var = t((c,), "float32").abs() + 0.5
        rstd = torch.rsqrt(var + 1e-5)
        act = "relu" if relu else ""
        args_ = (y, mean, rstd, scale, shift, res, act)
        key = f"{shape}-{has_res}-{relu}"
        out = cep.bn_apply_kernel(*args_)
        torch.cuda.synchronize()
        row = {"label": label, "shape": list(shape), "residual": has_res,
               "relu": relu, "per_step": count}
        if saved is not None:
            saved[key] = out.cpu()
        if want is not None:
            row["equal"] = bool(torch.equal(out.cpu(), want[key]))
            equal &= row["equal"]
        yn = y.permute(0, 3, 1, 2)
        rn = None if res is None else res.permute(0, 3, 1, 2)

        def library():
            o = F.batch_norm(yn, mean, var, scale, shift, False, 0.0, 1e-5)
            if rn is not None:
                o = o + rn
            return torch.relu(o) if relu else o

        def kernel():
            return cep.bn_apply_kernel(*args_)

        bound_ms, bound_by = bound_of(bn_times(RN_BATCH * oh * ow, c,
                                               has_res))
        row.update(ms=graph_ms(kernel, ITERS),
                   event_ms=cuda_ms(kernel, ITERS),
                   library_ms=graph_ms(library, ITERS),
                   library_event_ms=cuda_ms(library, ITERS),
                   bound_ms=bound_ms, bound_by=bound_by)
        row["bound_share"] = bound_ms / row["ms"]
        for k in ("ms", "event_ms", "library_ms", "library_event_ms",
                  "bound_ms"):
            totals[k] = totals.get(k, 0.0) + count * row[k]
        print("bn times " + json.dumps(row), flush=True)
        del y, res, out
        torch.cuda.empty_cache()
    if saved is not None:
        torch.save(saved, args.save)
    totals["bound_share"] = totals["bound_ms"] / totals["ms"]
    print("bn times per step " + json.dumps(
        {"label": label, **totals,
         **({"equal": equal} if want is not None else {})}), flush=True)
    print(f"device: {card_line()}", flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
