#!/usr/bin/env python3
"""The port's kernels as torch.profiler records them: interpreted calls
against CUDA-graph replays of one Executor path, in a process of its own.

Run on a card from the repository root:

    python3 tools/profile_replay.py [--path rn_convbnstats|infer_convep]
                                    [--pairs 3] [--all]

Builds the path as chip_smoke.py does (ResNet-50's conv_bn_stats training
step at batch 128, or the infer_convep inference leg at batch 128), counts
the kernel launches of one interpreted call, then profiles ``--pairs``
interpreted calls and as many replays of the path's CompiledProgram and
prints, for each, the records of the port's kernels by function beside the
launches (``--all``: every CUDA row).  chip_smoke.py's cross-check of a
profiled replay reads the same records in its one long process.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import numpy as np


def build(path, device):
    """(one call of the interpreted program, one of the compiled one)."""
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch as pt

    exe = pt.Executor(pt.CUDAPlace(0))
    if path == "rn_convbnstats":
        pt.set_flags({"conv_bn_stats": "on"})
        model, main, startup, _ = cs.build_resnet_program("conv_bn_stats")
        scope = pt.Scope()
        np.random.seed(0)
        exe.run(startup, scope=scope)
        feed = cs.resnet_batch(0, cs.RN_BATCH)
        fetch, prog = model["loss"].name, main
    else:
        pt.set_flags({"conv_epilogue": "on"})
        name, batch, side = cs.INFER_LEGS["infer_convep"]
        fetch, main, startup = cs.build_infer_model(name, side)
        scope = cs.init_infer_scope(main, startup, 0, device, side)
        prog = main.clone(for_test=True)
        pt.transpiler.InferenceTranspiler().transpile(
            prog, scope=scope, protected=[fetch])
        pt.transpiler.fuse_conv_epilogue(prog, protected=[fetch])
        pt.transpiler.nhwc_transpile(prog)
        pt.contrib.float16.bf16_transpile(prog, scope=scope)
        feed = cs.infer_feed(prog, 0, batch, side, device, torch.bfloat16)
    compiled = pt.CompiledProgram(prog)

    def call(program):
        return lambda: exe.run(program, feed=feed, fetch_list=[fetch],
                               scope=scope, return_numpy=False)

    return call(prog), call(compiled)


def records(fn, every):
    """{port kernel function: records} of one profiled call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    port = collections.Counter()
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if every:
            print(f"    {e.count:5d} {e.key[:150]}")
        m = cs.PORT_KERNEL.search(e.key)
        if m:
            port[m.group(1)] += e.count
    return dict(port)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default="infer_convep",
                    choices=("rn_convbnstats", "infer_convep"))
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_replay: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from paddle_tpu_torch import _build

    mm = torch.backends.cuda.matmul
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["conv_epilogue", "bn_apply"])
    print(f"card: {cs.card_line()}")
    interpreted, compiled = build(args.path, torch.device("cuda", 0))
    interpreted()
    cs.reset_kernel_counts()
    interpreted()
    torch.cuda.synchronize()
    launches = cs.per_call(cs.kernel_counts(), 1)
    compiled()
    compiled()
    torch.cuda.synchronize()
    print(f"{args.path}: {launches} launches of the port's kernels a call")
    for i in range(args.pairs):
        for what, fn in (("interpreted", interpreted), ("replay", compiled)):
            got = records(fn, args.all)
            print(f"{what} {i}: {sum(got.values())} records {got}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
