"""Device places, variable types and dtype names.

Counterpart of ``paddle_tpu/core/types.py``.  A Place names a torch
device: ``CPUPlace`` is the host, ``CUDAPlace(i)`` is CUDA device ``i``.
Resolving a ``CUDAPlace`` when no CUDA device is present raises
``NoCUDADeviceError``: nothing falls back to the CPU unless the caller
asked for ``CPUPlace``.

Dtypes travel through the IR as strings (``"float32"``, ``"int64"``,
``"bfloat16"``), exactly as the JAX package writes them, and map to
torch dtypes here.  ``to_numpy`` and ``from_numpy`` carry tensors across
the numpy boundary (fetch, feed, save, load); bfloat16 crosses as the
``ml_dtypes`` bfloat16 arrays the JAX package hands out, bit for bit.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class VarType(enum.Enum):
    DENSE_TENSOR = "dense_tensor"
    SELECTED_ROWS = "selected_rows"
    TENSOR_ARRAY = "tensor_array"
    READER = "reader"
    STEP_SCOPES = "step_scopes"
    RAW = "raw"

    # alias used in a few reference-style APIs
    LOD_TENSOR = "dense_tensor"


class NoCUDADeviceError(RuntimeError):
    """A CUDA place was asked for and no CUDA device is present."""


class Place:
    """Identifies the torch device a program's tensors live on."""

    device_type = "cpu"

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def __eq__(self, other):
        return (
            type(self) is type(other) and self.device_id == other.device_id
        )

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CPUPlace(Place):
    pass


class CUDAPlace(Place):
    device_type = "cuda"

    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise NoCUDADeviceError(
                f"{self!r}: no CUDA device is available; pass CPUPlace() "
                "(or Config.disable_gpu()) to run on the CPU")
        if self.device_id >= torch.cuda.device_count():
            raise NoCUDADeviceError(
                f"{self!r}: only {torch.cuda.device_count()} CUDA "
                "device(s) present")
        return torch.device("cuda", self.device_id)


_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def dtype_name(dtype) -> str:
    """Canonical IR dtype string for a str / numpy / torch dtype."""
    if isinstance(dtype, torch.dtype):
        return _DTYPE_NAMES[dtype]
    if isinstance(dtype, str) and dtype in _TORCH_DTYPES:
        return dtype
    return str(np.dtype(dtype))


def to_torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[dtype_name(dtype)]


class BFloat16NumpyError(TypeError):
    """A bfloat16 value has to become a numpy array and ``ml_dtypes``,
    which gives numpy its bfloat16 type, is not installed."""


def to_numpy(t: torch.Tensor, name: str) -> np.ndarray:
    """A host numpy copy of tensor ``t`` (the var ``name``).  A CUDA
    tensor is copied into page-locked memory from PyTorch's caching
    host allocator (a ``non_blocking`` copy, then a synchronise on the
    current stream), and the array is a view of that host tensor: a
    pageable copy of a 500 MB fetch runs at a fraction of the link's
    rate.  bfloat16 becomes an ``ml_dtypes.bfloat16`` array of the same
    bits, through a 16-bit integer view (numpy has no bfloat16 of its
    own)."""
    t = t.detach()
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        t = host
    else:
        t = t.cpu().clone()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        import ml_dtypes
    except ImportError as e:
        raise BFloat16NumpyError(
            f"var '{name}' is bfloat16: numpy needs the ml_dtypes package "
            "to hold it") from e
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def from_numpy(a, name: str) -> torch.Tensor:
    """A tensor of array ``a`` (the var ``name``) sharing its memory.  An
    ``ml_dtypes.bfloat16`` array, or the ``|V2`` records ``np.savez``
    stores one as, becomes a bfloat16 tensor of the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.dtype("V2") or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    try:
        return torch.from_numpy(a)
    except TypeError as e:
        raise TypeError(f"var '{name}': numpy dtype {a.dtype} has no "
                        "torch counterpart") from e
