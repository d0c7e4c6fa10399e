"""PCPM gather phase (paper alg. 5) as a CUDA kernel written for Hopper.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/pcpm_spmv/kernel.py::pcpm_gather_pallas``. The
source is ``repro_torch/csrc/pcpm_gather.cu``; ``kernels/_build.py``
compiles it with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, keyed on a hash of the source, and it is
bound with ``ctypes``; ``kernels/_launch.py`` keeps the launch's host
side short.

Bound: bytes. One call must read the two int32 index streams once (8 B
per edge), each real update's bins row once (U·d values) and write the
(k, P, d) output once; at PageRank sizes (d = 1) that is a few hundred
MB per call against the card's 3.35 TB/s. Two paths, chosen by
``b1_path`` from d and from whether the caller gives a gather order
(the source note in the ``.cu`` file has their designs):

- ``"tile"``: d = 1 with an ``ops.TileSchedule``: the paper's gather.
  Update values are read in order and added into a tile of destinations
  in shared memory (the tile's heaviest destinations in registers),
  flushed with vector reductions; no pad slot is read.
- ``"warp"``: everything else (d > 1, the blocked streams alone, any
  order): one edge per lane, runs of equal destinations merged inside a
  warp before one float32 global ``atomicAdd`` per run.

``pcpm_gather_cuda`` launches the kernel for CUDA tensors and raises on
what it cannot take; for CPU tensors it computes the plain version of
the chosen path (``ref.py``). There is no other fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, _launch
from .ref import pcpm_gather_ref, tile_gather_ref

SOURCE = _build.CSRC / "pcpm_gather.cu"
PATHS = ("warp", "tile")              # their codes in the C interface
# the C interface's arguments, in the order of ``enum Arg`` in the source
ARGS = _launch.Args("path", "bf16", "bins", "edge_upd", "edge_dst", "acc",
                    "out", "k", "U", "n_eb", "Eb", "P", "d", "tile_upd",
                    "tile_dst", "chunks", "block_chunks", "hub_table",
                    "tile", "blocks")

# Calls of ``pcpm_gather_cuda`` that launched on the card in this process
# (CPU calls of the plain version do not count), in all and per path.
# Reset by assigning 0 and ``dict.fromkeys(PATHS, 0)``.
launch_count = 0
launch_counts = dict.fromkeys(PATHS, 0)
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
    lib.pcpm_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.pcpm_gather.restype = ctypes.c_int
    _lib = lib
    return lib


def b1_path(d: int, has_schedule: bool) -> str:
    """The kernel path for a gather of width ``d``: "tile" for d = 1 when
    the caller gives the plan's ``TileSchedule``, else "warp". A pure
    function of shape and schedule; not a fallback."""
    return "tile" if d == 1 and has_schedule else "warp"


def _check(bins: torch.Tensor, edge_upd: torch.Tensor,
           edge_dst: torch.Tensor, part_size: int, schedule) -> None:
    if bins.dim() != 3:
        raise ValueError(f"bins must be (k, U, d); got {tuple(bins.shape)}")
    if bins.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bins must be float32 or bfloat16; got {bins.dtype}")
    eu_shape = edge_upd.shape
    if len(eu_shape) != 3 or eu_shape != edge_dst.shape:
        raise ValueError(
            "edge_upd/edge_dst must both be (k, n_eb, Eb); got "
            f"{tuple(eu_shape)} and {tuple(edge_dst.shape)}")
    if edge_upd.dtype != torch.int32 or edge_dst.dtype != torch.int32:
        raise TypeError("edge_upd/edge_dst must be int32; got "
                        f"{edge_upd.dtype} and {edge_dst.dtype}")
    if eu_shape[0] != bins.shape[0]:
        raise ValueError(f"bins has {bins.shape[0]} partitions, the edge "
                         f"streams {eu_shape[0]}")
    if part_size < 1:
        raise ValueError(f"part_size must be >= 1; got {part_size}")
    dev = bins.device
    if edge_upd.device != dev or edge_dst.device != dev:
        raise ValueError("bins and edge streams must share one device; got "
                         f"{dev}, {edge_upd.device}, {edge_dst.device}")
    if schedule is not None and (
            schedule.part_size != part_size
            or schedule.num_partitions != eu_shape[0]
            or schedule.edge_upd.device != dev):
        raise ValueError(
            f"the schedule (P={schedule.part_size}, k="
            f"{schedule.num_partitions}, on {schedule.edge_upd.device}) "
            f"is not of these streams (P={part_size}, k={eu_shape[0]}, "
            f"on {dev})")


def launch_args(path: str, bins: torch.Tensor, edge_upd: torch.Tensor,
                edge_dst: torch.Tensor, acc: torch.Tensor,
                out: torch.Tensor | None, part_size: int,
                schedule=None) -> bytes:
    """The packed C arguments of one launch (``ARGS`` order)."""
    k, num_updates, d = bins.shape
    _, n_eb, eb = edge_upd.shape
    tile = ((0,) * 7 if path == "warp" else (
        schedule.edge_upd.data_ptr(), schedule.edge_dst.data_ptr(),
        schedule.chunks.data_ptr(), schedule.block_chunks.data_ptr(),
        schedule.hubs.data_ptr(), schedule.tile, schedule.blocks))
    return ARGS.pack(PATHS.index(path), int(bins.dtype == torch.bfloat16),
                     bins.data_ptr(), edge_upd.data_ptr(),
                     edge_dst.data_ptr(), acc.data_ptr(),
                     0 if out is None else out.data_ptr(), k, num_updates,
                     n_eb, eb, part_size, d, *tile)


def pcpm_gather_cuda(bins: torch.Tensor, edge_upd: torch.Tensor,
                     edge_dst: torch.Tensor, *, part_size: int,
                     schedule=None) -> torch.Tensor:
    """bins: (k, U, d); edge_upd/edge_dst: (k, n_eb, Eb) -> (k, P, d).

    The counterpart of the JAX package's ``pcpm_gather_pallas``: sums in
    float32 and returns ``bins``' dtype. ``schedule``, an
    ``ops.TileSchedule`` built from the same streams, selects the "tile"
    path at d = 1 (``b1_path``). CUDA tensors go to the kernel (or
    raise); CPU tensors go to the path's plain version.
    """
    global launch_count
    _check(bins, edge_upd, edge_dst, part_size, schedule)
    k, num_updates, d = bins.shape
    path = b1_path(d, schedule is not None)
    dev = bins.device
    if dev.type == "cpu":
        if path == "tile":
            return tile_gather_ref(bins, schedule)
        return pcpm_gather_ref(bins, edge_upd, edge_dst, part_size=part_size)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _launch.check_hopper(dev, "PCPM gather")
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
    acc = torch.zeros((k, part_size, d), dtype=torch.float32, device=dev)
    out = acc
    if bins.dtype == torch.bfloat16:
        out = torch.empty((k, part_size, d), dtype=torch.bfloat16, device=dev)
    args = launch_args(path, bins, edge_upd, edge_dst, acc,
                       None if out is acc else out, part_size, schedule)
    with _launch.device_guard(dev):
        err = lib.pcpm_gather(args, _launch.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"pcpm_gather kernel launch failed (path "
                           f"{path!r}): CUDA error {err}")
    launch_count += 1
    launch_counts[path] += 1
    return out
