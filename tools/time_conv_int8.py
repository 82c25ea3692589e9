#!/usr/bin/env python3
"""Times the port's int8 kernels (#9 conv_int8, #10 quantize_act) of one
source tree on one NVIDIA GPU, by CUDA-graph replay and by CUDA events,
at every int8 op of the infer_i8 and infer_i8_inter legs (ResNet-50 at
batch 128, as ``chip_smoke.py`` phase 16 converts it), and checks that
two trees' outputs are equal.

    python3 tools/time_conv_int8.py [--root DIR] [--label NAME]
                                    [--save FILE | --against FILE]

``--root`` is the checkout whose ``paddle_tpu_torch`` is timed (default:
this one), so two versions of the kernels are compared on one card in
one call, in turns: ``--root old``, then this tree twice, then ``old``
again.  A tree without ``quantize_act`` is timed on its PyTorch
quantisation (``_quantize_act``).  Operands are made from the same seed
in every run; ``--save`` writes every output to FILE, and ``--against``
loads such a file and fails unless every output is ``torch.equal`` to
it.  Prints one JSON line per (shape, epilogue) of conv_int8 (launches a
batch in each leg, ms, event_ms, the bound, torch._int_mm on an explicit
im2col made outside the timing, cuDNN's bf16 convolution) and per float
input of quantize_act, one line with the sums over a batch of each leg,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEGS = ("infer_i8", "infer_i8_inter")
ITERS = 10


def leg_shapes(device, seed):
    """{int8_op_shapes key: {leg: launches a batch}} of the two legs, the
    dtypes read from each leg's scope after one batch-2 run."""
    from chip_smoke import (INFER_LEGS, infer_feed, int8_op_shapes,
                            int8_program)

    shapes = {}
    for leg in LEGS:
        program, scope, fetch, exe, _ = int8_program(leg, seed, device)
        _, batch, side = INFER_LEGS[leg]
        exe.run(program, feed=infer_feed(program, seed, 2, side, device),
                fetch_list=[fetch], scope=scope)
        for key, count in int8_op_shapes(program, batch, scope).items():
            shapes.setdefault(key, {})[leg] = count
        del program, scope
    return shapes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--save", default=None)
    group.add_argument("--against", default=None)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_conv_int8: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import (bound_of, card_line, cuda_ms, graph_ms,
                            int8_operands, int8_times, quantize_times)

    sys.path.insert(0, os.path.abspath(args.root))
    from paddle_tpu_torch.ops import quant as Q

    quantize = getattr(Q, "quantize_act", None) or Q._quantize_act
    mm = torch.backends.cuda.matmul
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    label = args.label or os.path.abspath(args.root)
    device = torch.device("cuda", 0)
    shapes = leg_shapes(device, args.seed)
    torch.cuda.empty_cache()
    rng = np.random.RandomState(args.seed)
    outputs, totals = {}, {}

    def add(leg_counts, **times):
        for leg, count in leg_counts.items():
            for k, v in times.items():
                totals.setdefault(leg, {}).setdefault(k, 0.0)
                totals[leg][k] += count * v

    for key in sorted(shapes, key=str):
        n, h, w, cin, cout, k, s, p, d, g = key[:10]
        subset = key[10]
        x8 = torch.from_numpy(rng.randint(-127, 128, (n, h, w, cin))
                              .astype(np.int8)).to(device)
        wt = torch.from_numpy(rng.randint(-127, 128, (cout, cin // g, k, k))
                              .astype(np.int8)).to(device)
        oh = (h + 2 * p - (k - 1) * d - 1) // s + 1
        ow = (w + 2 * p - (k - 1) * d - 1) // s + 1
        ops = int8_operands(rng, device, (n, oh, ow, cout), subset)
        conv = dict(strides=(s, s), paddings=(p, p), dilations=(d, d),
                    groups=g)

        def kernel():
            return Q.conv_int8(x8, wt, **ops, **conv)

        outputs[f"conv {key}"] = kernel().cpu()
        cols = F.unfold(x8.permute(0, 3, 1, 2).float(), (k, k), dilation=d,
                        padding=p, stride=s)
        kk = cols.shape[1]
        a_mat = F.pad(cols.transpose(1, 2).reshape(-1, kk),
                      (0, -kk % 8)).to(torch.int8).contiguous()
        b_mat = F.pad(wt.reshape(cout, -1).float(),
                      (0, -kk % 8, 0, -cout % 8)).to(torch.int8).contiguous().t()
        del cols
        xb = x8.permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bound, bound_by = bound_of(int8_times(*key[:10], subset))
        row = {"label": label, "kernel": "conv_int8",
               "shape": list(key[:10]), "epilogue": list(subset),
               "x_dtype": key[11], "per_batch": shapes[key],
               "ms": graph_ms(kernel, ITERS),
               "event_ms": cuda_ms(kernel, ITERS),
               "int_mm_ms": graph_ms(lambda: torch._int_mm(a_mat, b_mat),
                                     ITERS),
               "cudnn_bf16_ms": graph_ms(lambda: F.conv2d(
                   xb, wb, stride=s, padding=p, dilation=d, groups=g),
                   ITERS),
               "bound_ms": bound, "bound_by": bound_by}
        print("int8 times " + json.dumps(row), flush=True)
        add(shapes[key], **{f"conv_int8_{t}": row[t] for t in (
            "ms", "event_ms", "int_mm_ms", "cudnn_bf16_ms", "bound_ms")})
        del x8, wt, ops, a_mat, b_mat, xb, wb
        torch.cuda.empty_cache()

    # the float inputs of the int8 ops: x as the op hands it over
    xs = {}
    for key, counts in shapes.items():
        if key[11] != "int8":
            x_key = key[:4] + (key[11],)
            for leg, count in counts.items():
                xs.setdefault(x_key, {}).setdefault(leg, 0)
                xs[x_key][leg] += count
    for x_key in sorted(xs):
        n, h, w, c, dtype = x_key
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.randint(1 << 30)))
        x = (torch.randn((n, h, w, c), generator=gen, device=device)
             * 40.0).to(getattr(torch, dtype))
        sx = torch.tensor(float(rng.uniform(20.0, 60.0)), device=device)
        outputs[f"quantize {x_key}"] = quantize(x, sx, 127.0).cpu()
        bound, bound_by = bound_of(quantize_times(x.numel(), dtype))
        row = {"label": label, "kernel": "quantize_act",
               "shape": [n, h, w, c], "dtype": dtype, "per_batch": xs[x_key],
               "ms": graph_ms(lambda: quantize(x, sx, 127.0), ITERS),
               "event_ms": cuda_ms(lambda: quantize(x, sx, 127.0), ITERS),
               "bound_ms": bound, "bound_by": bound_by}
        print("int8 times " + json.dumps(row), flush=True)
        add(xs[x_key], **{f"quantize_{t}": row[t] for t in (
            "ms", "event_ms", "bound_ms")})
        del x
    print("int8 times per batch " + json.dumps({"label": label, **totals}),
          flush=True)
    status = 0
    if args.save:
        torch.save(outputs, args.save)
    if args.against:
        ref = torch.load(args.against)
        diff = [k for k in outputs if k not in ref
                or not torch.equal(outputs[k], ref[k])]
        print("int8 outputs against " + json.dumps({
            "file": args.against, "compared": len(outputs),
            "differ": diff}), flush=True)
        status = 1 if diff or set(ref) != set(outputs) else 0
    print(f"device: {card_line()}", flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())
