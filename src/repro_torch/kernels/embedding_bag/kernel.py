"""Sum-mode embedding bag (kernel B2) as a CUDA kernel written for Hopper.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas``. The
source is ``repro_torch/csrc/embedding_bag.cu``; ``kernels/_build.py``
compiles it with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, and it is bound with ``ctypes``.

Bound: bytes. A call must read each id once, each distinct valid row once
and write the (B, d) output once. The design reads rows by index (no
vocabulary tiling, no one-hot product, no padding of V, B or d, all TPU
devices): a group of threads owns one bag, each thread a 16-byte chunk
of columns with a float32 accumulator; ids >= V are skipped without a
read, ids < 0 read row 0, as the plain version clips. ``geometry`` gives
the launch shape the kernel assumes; the source note in the ``.cu`` file
gives the rest.

``embedding_bag_cuda`` launches the kernel for CUDA tensors and raises on
what it cannot take; for CPU tensors it computes the plain version
(``ref.embedding_bag_ref``). There is no other fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import embedding_bag_ref

SOURCE = _build.CSRC / "embedding_bag.cu"
THREADS = 256             # threads per block: kThreads in the source
TABLE_DTYPES = (torch.float32, torch.bfloat16)
ID_DTYPES = (torch.int32, torch.int64)

# Kernel launches made by ``embedding_bag_cuda`` in this process (CPU
# calls of the plain version do not count). Reset it by assigning 0.
launch_count = 0
# What the last build did: seconds spent in nvcc (0.0 when the library
# was already built) and the compiler's report (registers, spills).
build_seconds = 0.0
build_log = ""

_lib = None


def load_library() -> ctypes.CDLL:
    """Build (once per source hash, ``kernels/_build.py``) and load the
    kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, built = _build.load(SOURCE)
    build_seconds, build_log = built.seconds, built.log
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.embedding_bag_fwd.argtypes = (
        [i32, i32, ptr, i64, i64, ptr, i64, i64, ptr, i64, i64, ptr, i64]
        + [i32] * 3 + [i64, ptr])
    lib.embedding_bag_fwd.restype = i32
    _lib = lib
    return lib


def geometry(num_bags: int, d: int, element_size: int
             ) -> tuple[int, int, int]:
    """(columns per thread, threads per bag, blocks) of a launch: each
    thread loads 16 bytes of a row (4 float32 or 8 bfloat16 columns), a
    bag takes ceil(d / columns) threads up to a whole block, and a block
    of ``THREADS`` holds ``THREADS // group`` bags."""
    vec = 16 // element_size
    group = min(-(-d // vec), THREADS)
    return vec, group, -(-num_bags // (THREADS // group))


def _check(table: torch.Tensor, idx: torch.Tensor,
           weights: torch.Tensor | None) -> None:
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"table must be (V, d) with V >= 1; got "
                         f"{tuple(table.shape)}")
    if table.dtype not in TABLE_DTYPES:
        raise TypeError(f"table must be float32 or bfloat16; got "
                        f"{table.dtype}")
    if idx.dim() != 2:
        raise ValueError(f"idx must be (B, L); got {tuple(idx.shape)}")
    if idx.dtype not in ID_DTYPES:
        raise TypeError(f"idx must be int32 or int64; got {idx.dtype}")
    if weights is not None:
        if weights.shape != idx.shape:
            raise ValueError(f"weights {tuple(weights.shape)} must have the "
                             f"shape of idx {tuple(idx.shape)}")
        if not weights.is_floating_point():
            raise TypeError(f"weights must be floating point; got "
                            f"{weights.dtype}")
    devices = {table.device, idx.device}
    if weights is not None:
        devices.add(weights.device)
    if len(devices) != 1:
        raise ValueError(f"table, idx and weights must share one device; "
                         f"got {sorted(map(str, devices))}")


def embedding_bag_cuda(table: torch.Tensor, idx: torch.Tensor,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """table (V, d) float32 or bfloat16; idx (B, L) int32 or int64 (pad:
    any id >= V); weights (B, L) or None -> (B, d) in the table's dtype.

    The counterpart of the JAX package's ``embedding_bag_pallas`` without
    its padding. CUDA tensors go to the kernel (or raise); CPU tensors go
    to the plain version.
    """
    global launch_count
    _check(table, idx, weights)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, idx, weights)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if torch.cuda.get_device_capability(table.device) != (9, 0):
        raise RuntimeError(
            "the embedding bag kernel is built for sm_90a (Hopper); device "
            f"{torch.cuda.get_device_name(table.device)} has compute "
            f"capability {torch.cuda.get_device_capability(table.device)}")
    v, d = table.shape
    b, l = idx.shape
    if table.stride(1) != 1:
        raise ValueError("table must have a contiguous last dimension")
    if l >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: L={l}, d={d}")
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0 or d == 0:
        return out
    _, group, blocks = geometry(b, d, table.element_size())
    if blocks >= 2 ** 31:
        raise ValueError(f"{b} bags need {blocks} blocks, above the grid's "
                         "2**31 - 1")
    w = None if weights is None else weights.to(torch.float32)
    lib = load_library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.embedding_bag_fwd(
            int(table.dtype == torch.bfloat16), int(idx.dtype == torch.int64),
            table.data_ptr(), v, table.stride(0), idx.data_ptr(),
            *idx.stride(), None if w is None else w.data_ptr(),
            *((0, 0) if w is None else w.stride()), out.data_ptr(), b, l, d,
            group, blocks, stream)
    if err != 0:
        raise RuntimeError(f"embedding bag kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return out
