"""Builds the CUDA kernels of ``csrc/`` and the host C++ runtime of
``native/src/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<digest>.so``, where the
digest covers the source, the headers beside it (``csrc/*.cuh``) and
the flags, and is loaded with ``ctypes``.
Nothing is built at import: the first call of a kernel's wrapper on a
CUDA tensor builds it, or ``build()`` builds several at once, one
``nvcc`` process per source, all started together.

The host runtime (the blocking queue, recordio and the MultiSlot parser
of ``native/``) is plain C++: ``build_host()`` compiles its sources with
``g++`` into ``_build/libpt_native-<digest>.so``, the digest covering
every source and header under ``native/src/`` and the flags, at the
first use of ``native``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

HOST_SRC_DIR = PKG_DIR / "native" / "src"
HOST_SOURCES = ("blocking_queue.cc", "recordio.cc", "data_feed.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_LIBS: dict = {}

# Each source's kernel functions and the kernel-entry annotation names
# (observability/device_trace.py) they run under, the first the default.
# A kernel replayed from a CUDA graph runs under no entry annotation, so
# a device-trace session names it from its function; the int8 kernels
# have no annotation site (their JAX counterparts are XLA ops).
KERNEL_SYMBOLS = {
    "flash_attention_fwd": (("flash_fwd_bf16_kernel", "flash_fwd_f32_kernel",
                             "flash_fwd_wide_kernel"), ("flash_attention",)),
    "flash_attention_bwd": (("flash_bwd_dq_bf16_kernel",
                             "flash_bwd_dkv_bf16_kernel",
                             "flash_bwd_dq_f32_kernel",
                             "flash_bwd_dkv_f32_kernel",
                             "flash_bwd_dq_wide_kernel",
                             "flash_bwd_dkv_wide_kernel"),
                            ("flash_attention",)),
    "flash_decode": (("flash_decode_kernel", "flash_decode_wide_kernel",
                      "flash_decode_merge_kernel"), ("flash_decode",)),
    "fc_epilogue": (("fc_ep_bf16_kernel", "fc_wgmma_kernel",
                     "fc_ep_f32_kernel"), ("fc_epilogue",)),
    "conv_epilogue": (("conv_wgmma_kernel", "conv_f32_kernel"),
                      ("conv2d_epilogue", "conv2d_bn_act")),
    "bn_apply": (("bn_apply_masked_kernel", "bn_apply_tiled_kernel"),
                 ("conv2d_bn_act",)),
    "conv_int8": (("conv_int8_kernel", "conv_int8_wgmma_kernel"), ()),
    "quantize_act": (("quantize_act_kernel",), ()),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin "
                           "directory on PATH or set CUDA_HOME")
    return nvcc


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``; its digest covers the source,
    every header under ``csrc/`` and the flags, so an edited header
    never reuses a stale library."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every named kernel whose library is missing, all in
    parallel.  Returns {name: compiler log} for the ones compiled here;
    raises RuntimeError naming the source when nvcc fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (target, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    failed = []
    for name, (target, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu:\n{logs[name]}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def host_library_path() -> Path:
    """The host runtime's library; its digest covers every source and
    header under ``native/src/`` and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in sorted(HOST_SRC_DIR.glob("*")):
        if path.suffix in (".cc", ".h"):
            digest.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"libpt_native-{digest.hexdigest()[:16]}.so"


def build_host() -> Path:
    """Compile the host runtime with ``g++`` unless its library exists
    (a temporary file renamed into place, so processes building at once
    never load a half-written one).  Raises RuntimeError with the
    compiler's output when it fails or no C++ compiler is found."""
    target = host_library_path()
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found: set CXX or put g++ on "
                           "PATH")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp),
         *(str(HOST_SRC_DIR / src) for src in HOST_SOURCES), "-lpthread"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for native/src:\n{proc.stdout}")
    os.replace(tmp, target)
    return target
