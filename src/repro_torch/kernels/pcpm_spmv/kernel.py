"""PCPM gather phase (paper alg. 5) as a CUDA kernel written for Hopper.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/pcpm_spmv/kernel.py::pcpm_gather_pallas``. The
source is ``repro_torch/csrc/pcpm_gather.cu``; ``kernels/_build.py``
compiles it with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, keyed on a hash of the source, and it is
bound with ``ctypes``.

Bound: bytes. One call must read the two int32 index streams once (8 B
per edge), each real update's bins row once (U·d values) and write the
(k, P, d) output once; at PageRank sizes (d = 1) that is a few hundred
MB per call against the card's 3.35 TB/s. The pad slots of the edge
streams are not part of the bound: reading them is the blocked
layout's cost, charged to the kernel. The design answers it by reading each bins row
directly by index (no one-hot products, which are a TPU device) and by
merging runs of equal destinations inside a warp before the float32
``atomicAdd``, so the dst-sorted PNG stream costs about one atomic per
destination run instead of one per edge. The source note in the ``.cu``
file gives the layout.

``pcpm_gather_cuda`` launches the kernel for CUDA tensors and raises on
what it cannot take; for CPU tensors it computes the plain version
(``ref.pcpm_gather_ref``). There is no other fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import pcpm_gather_ref

SOURCE = _build.CSRC / "pcpm_gather.cu"

# Kernel launches made by ``pcpm_gather_cuda`` in this process (CPU calls
# of the plain version do not count). Reset it by assigning 0.
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
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pcpm_gather_f32.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.pcpm_gather_f32.restype = i32
    lib.pcpm_gather_bf16.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.pcpm_gather_bf16.restype = i32
    _lib = lib
    return lib


def _check(bins: torch.Tensor, edge_upd: torch.Tensor,
           edge_dst: torch.Tensor, part_size: int) -> None:
    if bins.dim() != 3:
        raise ValueError(f"bins must be (k, U, d); got {tuple(bins.shape)}")
    if bins.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bins must be float32 or bfloat16; got {bins.dtype}")
    if edge_upd.dim() != 3 or edge_upd.shape != edge_dst.shape:
        raise ValueError(
            "edge_upd/edge_dst must both be (k, n_eb, Eb); got "
            f"{tuple(edge_upd.shape)} and {tuple(edge_dst.shape)}")
    if edge_upd.dtype != torch.int32 or edge_dst.dtype != torch.int32:
        raise TypeError("edge_upd/edge_dst must be int32; got "
                        f"{edge_upd.dtype} and {edge_dst.dtype}")
    if edge_upd.shape[0] != bins.shape[0]:
        raise ValueError(f"bins has {bins.shape[0]} partitions, the edge "
                         f"streams {edge_upd.shape[0]}")
    if part_size < 1:
        raise ValueError(f"part_size must be >= 1; got {part_size}")
    if len({bins.device, edge_upd.device, edge_dst.device}) != 1:
        raise ValueError("bins and edge streams must share one device; got "
                         f"{bins.device}, {edge_upd.device}, "
                         f"{edge_dst.device}")


def pcpm_gather_cuda(bins: torch.Tensor, edge_upd: torch.Tensor,
                     edge_dst: torch.Tensor, *, part_size: int) -> torch.Tensor:
    """bins: (k, U, d); edge_upd/edge_dst: (k, n_eb, Eb) -> (k, P, d).

    The counterpart of the JAX package's ``pcpm_gather_pallas``: sums in
    float32 and returns ``bins``' dtype. CUDA tensors go to the kernel
    (or raise); CPU tensors go to the plain version.
    """
    global launch_count
    _check(bins, edge_upd, edge_dst, part_size)
    if bins.device.type == "cpu":
        return pcpm_gather_ref(bins, edge_upd, edge_dst, part_size=part_size)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    if torch.cuda.get_device_capability(bins.device) != (9, 0):
        raise RuntimeError(
            "the PCPM gather kernel is built for sm_90a (Hopper); device "
            f"{torch.cuda.get_device_name(bins.device)} has compute "
            f"capability {torch.cuda.get_device_capability(bins.device)}")
    k, num_updates, d = bins.shape
    _, n_eb, eb = edge_upd.shape
    if k > 65535 or max(num_updates, n_eb, eb, part_size, d,
                        k * part_size * d) >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: k={k} (max "
                         f"65535), U={num_updates}, n_eb={n_eb}, Eb={eb}, "
                         f"P={part_size}, d={d}")
    for name, t in (("bins", bins), ("edge_upd", edge_upd),
                    ("edge_dst", edge_dst)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = load_library()
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        acc = torch.zeros((k, part_size, d), dtype=torch.float32,
                          device=bins.device)
        dims = (k, num_updates, n_eb, eb, part_size, d)
        if bins.dtype == torch.float32:
            out = acc
            err = lib.pcpm_gather_f32(bins.data_ptr(), edge_upd.data_ptr(),
                                      edge_dst.data_ptr(), acc.data_ptr(),
                                      *dims, stream)
        else:
            out = torch.empty((k, part_size, d), dtype=torch.bfloat16,
                              device=bins.device)
            err = lib.pcpm_gather_bf16(bins.data_ptr(), edge_upd.data_ptr(),
                                       edge_dst.data_ptr(), acc.data_ptr(),
                                       out.data_ptr(), *dims, stream)
    if err != 0:
        raise RuntimeError(f"pcpm_gather kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return out
