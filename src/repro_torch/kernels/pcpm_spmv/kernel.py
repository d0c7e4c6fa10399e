"""PCPM gather phase (paper alg. 5) as a CUDA kernel written for Hopper.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/pcpm_spmv/kernel.py::pcpm_gather_pallas``. The
source is ``repro_torch/csrc/pcpm_gather.cu``; ``kernels/_build.py``
compiles it with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, keyed on a hash of the source, and it is
bound with ``ctypes``; ``kernels/_launch.py`` keeps the launch's host
side short.

Bound: bytes. One call must read the two int32 index streams once (8 B
per edge), each real update's row of bins once (U·d values; in the
fused form each real update's ``update_src`` entry and x once, n·d
values) and write the (k, P, d) output once; at
PageRank sizes (d = 1) that is a few hundred MB per call against the
card's 3.35 TB/s. Two paths, chosen by ``b1_path`` from d and from
whether the caller gives a gather order (the source note in the ``.cu``
file has their designs):

- ``"tile"``: d = 1 with an ``ops.TileSchedule``: the paper's gather.
  Update values are read in order and added into a tile of destinations
  in shared memory (the tile's heaviest destinations in registers),
  flushed with vector reductions; no pad slot is read. Its bins are
  ragged, the PNG's own U values with each partition's offset
  (``tile_gather_cuda``).
- ``"warp"``: everything else (d > 1, the blocked streams alone, any
  order): a group of lanes per edge, each lane a 16-byte slice of the
  row, each group summing runs of equal destinations along a range of
  the stream in registers and adding each run once with vector
  reductions (``WarpGeometry``). It reads each row through
  ``update_src``: in the fused form (``pcpm_spmv_cuda``) straight from
  the SpMV's input, so no (k, U, d) bins tensor exists; from bins
  (``pcpm_gather_cuda``) as rows of a (k·U, d) x with the identity
  ``update_src``.

``pcpm_gather_cuda``, ``tile_gather_cuda`` and ``pcpm_spmv_cuda`` launch
the kernel for CUDA tensors and raise on what it cannot take; for CPU
tensors they compute the plain version of the chosen path (``ref.py``).
There is no other fallback.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from .. import _build, _launch
from .ref import pcpm_gather_ref, pcpm_spmv_ref, tile_gather_ref

SOURCE = _build.CSRC / "pcpm_gather.cu"
PATHS = ("warp", "tile")              # their codes in the C interface
# the C interface's arguments, in the order of ``enum Arg`` in the source
ARGS = _launch.Args("path", "bf16", "rows", "update_src", "n", "edge_upd",
                    "edge_dst", "acc", "out", "k", "U", "n_eb", "Eb", "P",
                    "d", "vec", "lanes", "range", "tile_upd", "tile_dst",
                    "chunks", "block_chunks", "hub_table", "tile", "blocks",
                    "update_offsets")
# threads of a "warp" block (warp::kThreads in the source)
WARP_THREADS = 256

# Calls of ``pcpm_gather_cuda`` and ``pcpm_spmv_cuda`` that launched on
# the card in this process (CPU calls of the plain version do not count),
# in all and per path; both forms of "warp" count as "warp"; a replayed
# CUDA graph adds the launches it captured (``count_launches``). Reset by
# assigning 0 and ``dict.fromkeys(PATHS, 0)``. The gateway's device
# thread and push workers launch concurrently: ``_count_lock`` keeps
# their increments from losing one another, and each thread also keeps
# its own tally (``thread_launch_counts``).
launch_count = 0
launch_counts = dict.fromkeys(PATHS, 0)
_count_lock = threading.Lock()
_thread = threading.local()
# What the last build did: seconds spent in nvcc (0.0 when the library
# was already built) and the compiler's report (registers, spills).
build_seconds = 0.0
build_log = ""

_lib = None


def thread_launch_counts() -> dict:
    """The launches counted on the calling thread, by path: what a CUDA
    graph's capture takes back, whatever other threads launch
    meanwhile. Only differences of it mean anything."""
    counts = getattr(_thread, "counts", None)
    if counts is None:
        counts = _thread.counts = dict.fromkeys(PATHS, 0)
    return counts


def count_launches(counts: dict) -> None:
    """Add ``counts`` (launches by path) to ``launch_count``,
    ``launch_counts`` and the calling thread's tally: one launch of
    ``_run``, or what a CUDA graph's replay launches without calling
    it."""
    global launch_count
    mine = thread_launch_counts()
    with _count_lock:
        for path, c in counts.items():
            launch_count += c
            launch_counts[path] += c
    for path, c in counts.items():
        mine[path] += c


def load_library() -> ctypes.CDLL:
    """Build (once per source hash, ``kernels/_build.py``) and load the
    kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, built = _build.load(SOURCE)
    build_seconds, build_log = built.seconds, built.log
    bind(lib)
    _lib = lib
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument and result types on ``lib``."""
    lib.pcpm_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.pcpm_gather.restype = ctypes.c_int
    lib.pcpm_warp_occupancy.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.pcpm_warp_occupancy.restype = ctypes.c_int
    return lib


@dataclasses.dataclass(frozen=True)
class WarpGeometry:
    """How one "warp" launch cuts its work. ``vec`` row values a lane
    reads at once (16 bytes: 4 float32 or 8 bfloat16; 1 when d is not a
    multiple of that or the rows are not 16-byte aligned), ``lanes`` per
    edge (the group), ``blocks`` of ``WARP_THREADS`` threads (one wave),
    and ``range``, the slots a group takes a round (a multiple of the
    ``4 * lanes`` slots of its fetch)."""
    vec: int
    lanes: int
    blocks: int
    range: int

    @property
    def groups(self) -> int:
        return self.blocks * WARP_THREADS // self.lanes


def warp_lanes(d: int, bf16: bool, aligned: bool) -> tuple[int, int]:
    """(vec, lanes) of a d-wide row: 16-byte slices when d is a multiple
    of their width and the rows are 16-byte aligned, else one value a
    lane; as many lanes as slices, rounded up to a power of two, at most
    a warp's 32."""
    width = 8 if bf16 else 4
    vec = width if aligned and d % width == 0 else 1
    slices = -(-d // vec)
    return vec, min(32, 1 << (slices - 1).bit_length())


def warp_geometry(d: int, bf16: bool, aligned: bool, part_slots: int,
                  blocks_of) -> WarpGeometry:
    """The geometry of a launch over streams of ``part_slots`` slots a
    partition; ``blocks_of(vec, lanes)`` gives the blocks of one wave.
    ``range`` makes one round of all groups cover about one partition, so
    the rounds walk the stream partition after partition."""
    vec, lanes = warp_lanes(d, bf16, aligned)
    blocks = blocks_of(vec, lanes)
    fetch = 4 * lanes
    groups = blocks * WARP_THREADS // lanes
    return WarpGeometry(vec, lanes, blocks,
                        max(fetch, part_slots // (groups * fetch) * fetch))


@functools.cache
def _wave_blocks(device: torch.device, bf16: bool, vec: int,
                 lanes: int) -> int:
    """Blocks of one wave of the "warp" kernel on ``device``: its SMs
    times the kernel's resident blocks per SM."""
    per_sm = ctypes.c_int(0)
    err = load_library().pcpm_warp_occupancy(int(bf16), vec, lanes,
                                             ctypes.byref(per_sm))
    if err != 0 or per_sm.value < 1:
        raise RuntimeError(f"pcpm_warp_occupancy failed: CUDA error {err}, "
                           f"{per_sm.value} blocks per SM")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * per_sm.value


def b1_path(d: int, has_schedule: bool) -> str:
    """The kernel path for a gather of width ``d``: "tile" for d = 1 when
    the caller gives the plan's ``TileSchedule``, else "warp". A pure
    function of shape and schedule; not a fallback."""
    return "tile" if d == 1 and has_schedule else "warp"


def _check_streams(edge_upd: torch.Tensor, edge_dst: torch.Tensor,
                   k: int, part_size: int, dev: torch.device,
                   what: str) -> None:
    eu_shape = edge_upd.shape
    if len(eu_shape) != 3 or eu_shape != edge_dst.shape:
        raise ValueError(
            "edge_upd/edge_dst must both be (k, n_eb, Eb); got "
            f"{tuple(eu_shape)} and {tuple(edge_dst.shape)}")
    if edge_upd.dtype != torch.int32 or edge_dst.dtype != torch.int32:
        raise TypeError("edge_upd/edge_dst must be int32; got "
                        f"{edge_upd.dtype} and {edge_dst.dtype}")
    if eu_shape[0] != k:
        raise ValueError(f"{what} has {k} partitions, the edge streams "
                         f"{eu_shape[0]}")
    if part_size < 1:
        raise ValueError(f"part_size must be >= 1; got {part_size}")
    if edge_upd.device != dev or edge_dst.device != dev:
        raise ValueError(f"{what} and edge streams must share one device; "
                         f"got {dev}, {edge_upd.device}, {edge_dst.device}")


def _check_rows(rows: torch.Tensor, name: str, dim: int) -> None:
    if rows.dim() != dim:
        shape = "(k, U, d)" if dim == 3 else "(n, d)"
        raise ValueError(f"{name} must be {shape}; got {tuple(rows.shape)}")
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16; got "
                        f"{rows.dtype}")


def _stream_shape(edge_upd: torch.Tensor | None, schedule) -> tuple:
    """(k, n_eb, Eb) of the blocked streams ("warp"), or (k, 0, 0) for a
    "tile" launch, which has none."""
    if edge_upd is None:
        return schedule.num_partitions, 0, 0
    return tuple(edge_upd.shape)


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def launch_args(path: str, rows: torch.Tensor,
                edge_upd: torch.Tensor | None,
                edge_dst: torch.Tensor | None, acc: torch.Tensor,
                out: torch.Tensor | None, part_size: int, *,
                num_updates: int, update_src: torch.Tensor | None = None,
                geometry: WarpGeometry | None = None, schedule=None,
                update_offsets: torch.Tensor | None = None) -> bytes:
    """The packed C arguments of one launch (``ARGS`` order): "tile"
    takes ragged bins (U,) as ``rows`` with ``update_offsets`` (k + 1,)
    and a ``schedule``, and no blocked streams; "warp" takes x (n, d) as
    ``rows`` with ``update_src``, the blocked streams and a
    ``geometry``."""
    k, n_eb, eb = _stream_shape(edge_upd, schedule)
    d = 1 if rows.dim() == 1 else rows.shape[-1]
    fused = (0, 0) if update_src is None else (update_src.data_ptr(),
                                               rows.shape[0])
    warp = ((0, 0, 0) if geometry is None
            else (geometry.vec, geometry.lanes, geometry.range))
    tile = ((0,) * 6 if schedule is None else (
        schedule.edge_upd.data_ptr(), schedule.edge_dst.data_ptr(),
        schedule.chunks.data_ptr(), schedule.block_chunks.data_ptr(),
        schedule.hubs.data_ptr(), schedule.tile))
    blocks = geometry.blocks if path == "warp" else schedule.blocks
    return ARGS.pack(PATHS.index(path), int(rows.dtype == torch.bfloat16),
                     rows.data_ptr(), *fused, _ptr(edge_upd),
                     _ptr(edge_dst), acc.data_ptr(), _ptr(out), k,
                     num_updates, n_eb, eb, part_size, d, *warp, *tile,
                     blocks, _ptr(update_offsets))


def _run(path: str, rows: torch.Tensor, edge_upd: torch.Tensor | None,
         edge_dst: torch.Tensor | None, part_size: int, *, num_updates: int,
         update_src: torch.Tensor | None = None, schedule=None,
         update_offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Check what the card's kernel needs, launch it on the current
    stream and count the launch; (k, P, d) in ``rows``' dtype. ``rows``
    is ragged bins (U,) with ``update_offsets`` and no blocked streams
    for "tile", x (n, d) with ``update_src`` for "warp"."""
    dev = rows.device
    _launch.check_hopper(dev, "PCPM gather")
    k, n_eb, eb = _stream_shape(edge_upd, schedule)
    d = 1 if rows.dim() == 1 else rows.shape[-1]
    n = rows.shape[0] if update_src is not None else 0
    # int32 indices in the kernel; the stream's slots with room for the
    # "warp" loop's fetches past its end; update_src's k * U slots ("warp")
    slots = k * num_updates if path == "warp" else num_updates
    if k > 65535 or max(num_updates, n_eb, eb, part_size, d, n,
                        k * n_eb * eb + 1024, slots,
                        k * part_size * d) >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: k={k} (max "
                         f"65535), U={num_updates}, n_eb={n_eb}, Eb={eb}, "
                         f"P={part_size}, d={d}, n={n} (each product of "
                         "them below 2**31)")
    named = [("edge_upd", edge_upd), ("edge_dst", edge_dst),
             ("update_offsets", update_offsets)]
    named += ([("bins", rows)] if update_src is None
              else [("x", rows), ("update_src", update_src)])
    for name, t in named:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = load_library()
    bf16 = rows.dtype == torch.bfloat16
    geometry = None
    if path == "warp":
        for name, t in named[:2]:
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned on the "
                                 "card (the kernel reads it 16 bytes at a "
                                 "time)")
        geometry = warp_geometry(
            d, bf16, rows.data_ptr() % 16 == 0, n_eb * eb,
            lambda vec, lanes: _wave_blocks(dev, bf16, vec, lanes))
    acc = torch.zeros((k, part_size, d), dtype=torch.float32, device=dev)
    out = acc
    if bf16:
        out = torch.empty((k, part_size, d), dtype=torch.bfloat16, device=dev)
    args = launch_args(path, rows, edge_upd, edge_dst, acc,
                       None if out is acc else out, part_size,
                       num_updates=num_updates, update_src=update_src,
                       geometry=geometry, schedule=schedule,
                       update_offsets=update_offsets)
    with _launch.device_guard(dev):
        err = lib.pcpm_gather(args, _launch.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"pcpm_gather kernel launch failed (path "
                           f"{path!r}): CUDA error {err}")
    count_launches({path: 1})
    return out


def pcpm_gather_cuda(bins: torch.Tensor, edge_upd: torch.Tensor,
                     edge_dst: torch.Tensor, *, part_size: int) -> torch.Tensor:
    """bins: (k, U, d); edge_upd/edge_dst: (k, n_eb, Eb) -> (k, P, d).

    The counterpart of the JAX package's ``pcpm_gather_pallas``: sums in
    float32 and returns ``bins``' dtype, through B1's "warp" path (the
    blocked streams alone, any d; ``b1_path``). CUDA tensors go to the
    kernel (or raise); CPU tensors go to the plain version.
    """
    _check_rows(bins, "bins", 3)
    dev = bins.device
    _check_streams(edge_upd, edge_dst, bins.shape[0], part_size, dev, "bins")
    path = b1_path(bins.shape[2], False)       # no gather order: "warp"
    if dev.type == "cpu":
        return pcpm_gather_ref(bins, edge_upd, edge_dst, part_size=part_size)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k, num_updates, d = bins.shape
    if not bins.is_contiguous():
        raise ValueError("bins must be contiguous")
    # "warp" reads rows through update_src: bins as (k·U, d) rows of x
    # and the identity update_src
    identity = torch.arange(k * num_updates, dtype=torch.int32,
                            device=dev).view(k, num_updates)
    return _run(path, bins.view(k * num_updates, d), edge_upd, edge_dst,
                part_size, num_updates=num_updates, update_src=identity)


def tile_gather_cuda(bins: torch.Tensor, update_offsets: torch.Tensor,
                     schedule) -> torch.Tensor:
    """bins: (U,) or (U, 1), partition p's updates at
    ``update_offsets[p]`` up to ``update_offsets[p + 1]``;
    update_offsets: (k + 1,) int32 -> (k, P, 1).

    B1's "tile" path over ragged bins, a PNG's own updates with no pad
    (``ops.pcpm_spmv_tile``), in ``schedule``'s order, an
    ``ops.TileSchedule`` of the same PNG whose updates are
    partition-local. Sums in float32 and returns ``bins``' dtype. CUDA
    tensors go to the kernel (or raise); CPU tensors go to the plain
    version (``ref.tile_gather_ref``).
    """
    if bins.dim() == 2 and bins.shape[1] == 1:
        bins = bins.view(-1)
    if bins.dim() != 1:
        raise ValueError(f"ragged bins must be (U,) or (U, 1); got "
                         f"{tuple(bins.shape)}")
    _check_rows(bins[:, None], "bins", 2)
    k = schedule.num_partitions
    dev = bins.device
    if (update_offsets.shape != (k + 1,)
            or update_offsets.dtype != torch.int32):
        raise ValueError(f"update_offsets must be ({k + 1},) int32 for the "
                         f"schedule's {k} partitions; got "
                         f"{tuple(update_offsets.shape)} "
                         f"{update_offsets.dtype}")
    if update_offsets.device != dev or schedule.edge_upd.device != dev:
        raise ValueError(f"bins, update_offsets and the schedule must share "
                         f"one device; got {dev}, {update_offsets.device}, "
                         f"{schedule.edge_upd.device}")
    path = b1_path(1, True)                    # a gather order: "tile"
    if dev.type == "cpu":
        return tile_gather_ref(bins, schedule, update_offsets)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _run(path, bins, None, None, schedule.part_size,
                num_updates=bins.shape[0], schedule=schedule,
                update_offsets=update_offsets)


def pcpm_spmv_cuda(x: torch.Tensor, update_src: torch.Tensor,
                   edge_upd: torch.Tensor, edge_dst: torch.Tensor, *,
                   part_size: int) -> torch.Tensor:
    """x: (n, d); update_src: (k, U); edge_upd/edge_dst: (k, n_eb, Eb)
    -> (k, P, d): the gather of ``x[update_src]`` without the bins.

    B1's "warp" path in its fused form: each edge's row is read as
    ``x[update_src[p, edge_upd[p, e]]]`` inside the kernel, the paper's
    scatter phase moved into the gather's loads. Sums in float32 and
    returns ``x``' dtype. CUDA tensors go to the kernel (or raise: a
    non-contiguous ``x``, n ≥ 2**31; the kernel's row offsets are 64-bit,
    so n·d may exceed it); CPU tensors go to the plain
    version (``ref.pcpm_spmv_ref``). An ``update_src`` entry outside
    [0, n) makes the edges that read it pads, on the card and in the
    plain version.
    """
    _check_rows(x, "x", 2)
    if (update_src.dim() != 2 or update_src.dtype != torch.int32
            or update_src.shape[0] != edge_upd.shape[0]):
        raise ValueError("update_src must be (k, U) int32 with the edge "
                         f"streams' k; got {tuple(update_src.shape)} "
                         f"{update_src.dtype}")
    dev = x.device
    if update_src.device != dev:
        raise ValueError(f"x and update_src must share one device; got "
                         f"{dev}, {update_src.device}")
    _check_streams(edge_upd, edge_dst, update_src.shape[0], part_size, dev,
                   "update_src")
    path = b1_path(x.shape[1], False)          # no gather order: "warp"
    if dev.type == "cpu":
        return pcpm_spmv_ref(x, update_src, edge_upd, edge_dst,
                             part_size=part_size)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _run(path, x, edge_upd, edge_dst, part_size,
                num_updates=update_src.shape[1], update_src=update_src)
