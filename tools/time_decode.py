#!/usr/bin/env python3
"""Times the port's flash_decode kernel of one source tree on one NVIDIA
GPU, by CUDA-graph replay, at phase 11's shapes of ``chip_smoke.py``.

    python3 tools/time_decode.py [--root DIR] [--label NAME]
                                 [--save FILE | --against FILE]

``--root`` is the checkout whose ``paddle_tpu_torch`` is timed (default:
this one), so two versions of the kernel are compared on one card in
one call, in turns: ``--root old``, then this tree twice, then ``old``
again.  The cases are ``chip_smoke.DECODE_CASES`` named in ``TIMED``
(the server's step, its verify sweep, int8 pools, the draft model's
step, 64 x 4096 tokens, one 32768-token sequence as a step and as a
verify sweep), with inputs made from the same seed in every run.  Prints
one JSON line per case (ms, bound_ms, bound_share; a case the tree's
wrapper refuses is printed with its error), then the card's name and
power limit.  ``--save`` writes the output of every timed case and of the
cases in ``CHECKED`` (head dims 1536 and 2048) to FILE, and ``--against``
loads such a file and fails unless every output is ``torch.equal`` to
it: two trees' kernels compared bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMED = ("main", "main_verify", "main_int8", "draft", "bf16_verify",
         "int8_verify", "long_64x4096", "long_1x32768",
         "long_1x32768_verify")
CHECKED = ("d1536", "d1536_bf16_verify", "d2048_verify", "d2048_int8",
           "d2048_int8_verify")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default=None)
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--save", default=None)
    group.add_argument("--against", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_decode: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import (DECODE_CASES, card_line, decode_bound_ms,
                            decode_inputs, decode_lens, graph_ms)

    sys.path.insert(0, os.path.abspath(args.root))
    from paddle_tpu_torch.ops import flash_decode as fd

    label = args.label or os.path.abspath(args.root)
    device = torch.device("cuda", 0)
    cases = {c[0]: c for c in DECODE_CASES}
    outputs = {}
    for i, name in enumerate(TIMED + CHECKED):
        _, spec, r, h, d, ps, dtype, strided = cases[name]
        lens = decode_lens(spec, np.random.RandomState(i))
        q, k, v, tab, ln, scales = decode_inputs(
            i, lens, r, h, d, ps, dtype, strided, device)
        row = {"label": label, "name": name, "streams": len(lens),
               "tokens": sum(lens), "R": r, "d": d, "dtype": dtype}
        bound_ms, bound_by, _ = decode_bound_ms(lens, r, h, d, ps, dtype)

        def call():
            return fd.flash_decode(q, k, v, tab, ln, kv_scales=scales)

        try:
            outputs[name] = call().cpu()
        except (ValueError, TypeError) as e:
            row["refused"] = str(e)
        else:
            if name in TIMED:
                big = sum(lens) * h * r >= 64 * 4096 * 8
                ms = graph_ms(call, 5 if big else 20)
                row.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                           bound_share=bound_ms / ms)
        if name in TIMED or "refused" in row:
            print("decode times " + json.dumps(row), flush=True)
        del q, k, v, tab, ln, scales
        torch.cuda.empty_cache()
    status = 0
    if args.save:
        torch.save(outputs, args.save)
    if args.against:
        ref = torch.load(args.against)
        diff = sorted(k for k in set(ref) | set(outputs) if k not in ref
                      or k not in outputs or not torch.equal(outputs[k],
                                                             ref[k]))
        print("decode outputs against " + json.dumps({
            "file": args.against, "compared": len(outputs),
            "differ": diff}), flush=True)
        status = 1 if diff else 0
    print(f"device: {card_line()}", flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())
