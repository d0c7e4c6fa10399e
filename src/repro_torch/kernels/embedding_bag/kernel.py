"""Sum-mode embedding bag (kernel B2) as a CUDA kernel written for Hopper.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas``. The
source is ``repro_torch/csrc/embedding_bag.cu``; ``kernels/_build.py``
compiles it with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, and it is bound with ``ctypes``;
``kernels/_launch.py`` keeps the launch's host side short (at MIND's
serve_p99 the kernel takes a few microseconds on the card, so the
wrapper's Python sets the time of a call).

Bound: bytes. A call must read each id once, each distinct valid row once
and write the (B, d) output once. The design reads rows by index (no
vocabulary tiling, no one-hot product, no padding of V, B or d, all TPU
devices): a group of threads owns a bag, each thread a 16-byte chunk of
columns with a float32 accumulator, a few ids and rows in flight before
the first add, on persistent blocks (``geometry``,
``persistent_blocks``). Ids >= V give zeros and are never read; ids < 0
read row 0, as the plain version clips. The source note in the ``.cu``
file gives the rest.

``embedding_bag_cuda`` launches the kernel for CUDA tensors and raises on
what it cannot take; for CPU tensors it computes the plain version
(``ref.embedding_bag_ref``). There is no other fallback.

``embedding_bag_bwd_cuda`` is the backward, B2-bwd (the same source's
``embedding_bag_bwd``; it replaces no TPU kernel): the (V, d) gradient of
the table, dense, summed deterministically without float atomics. The
entries are sorted stably by the row they read (``ref.sorted_keys``, a
``torch.sort``); one C call then runs three kernels over a grid of
chunks of ``BWD_CHUNK`` sorted entries by column slabs
(``bwd_geometry``): each run of one row summed in entry order, its keys,
rows and weights staged in shared memory and its dout slabs streamed
through a ``cp.async`` ring (``bwd_form``), and written directly when it
lies inside its chunk, else left as per-chunk partials; a combine of
those partials in chunk order; and zeros for every row no entry reads.
``ref.embedding_bag_bwd_emulate`` replays that order on the CPU with the
kernel's bits.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import _build, _launch
from .ref import embedding_bag_bwd_ref, embedding_bag_ref, sorted_keys

SOURCE = _build.CSRC / "embedding_bag.cu"
THREADS = 256             # threads per block: kThreads in the source
TABLE_DTYPES = (torch.float32, torch.bfloat16)
ID_DTYPES = (torch.int32, torch.int64)
# the C interface's arguments, in the order of ``enum Arg`` in the source
ARGS = _launch.Args("table_bf16", "idx_64", "table", "V", "ld", "idx",
                    "idx_sb", "idx_sl", "w", "w_sb", "w_sl", "out", "B", "L",
                    "d", "group", "blocks")
# the backward's, in the order of ``enum BwdArg``
BWD_ARGS = _launch.Args("table_bf16", "dout", "keys", "perm", "w", "L", "N",
                        "V", "d", "grad", "present", "partials", "chunk",
                        "team", "slab_cols", "chunks_per_block",
                        "slabs_per_block", "threads", "chunk_blocks",
                        "slab_blocks", "zero_blocks", "form")
# resident blocks of THREADS an SM (2,048 threads)
BLOCKS_PER_SM = 2048 // THREADS
# sorted entries per chunk of the backward: a row read by more entries
# is summed over several chunks, then combined
BWD_CHUNK = 256
# the backward's chunks a block, at most (their keys, rows and weights
# are staged in shared memory), slabs a block, at most (a warp each), and
# ring slots of a walk (kRing)
BWD_MAX_CHUNKS_PER_BLOCK = 16
BWD_MAX_SLABS_PER_BLOCK = 8
BWD_RING = 8
# how a walk reads its dout slabs: plain loads, or 16-byte cp.async
# copies through the ring (``bwd_form``; the order of ``enum Form``)
BWD_FORMS = ("sync", "cp.async")
# the zero kernel's grid (it strides over the rows): 32 blocks of
# kThreads an SM of the H100's 132
ZERO_BLOCKS = 132 * 32

# Kernel launches made by ``embedding_bag_cuda`` and
# ``embedding_lookup_cuda`` in this process (CPU calls of the plain
# version do not count). Reset it by assigning 0.
launch_count = 0
# Calls of the backward that launched it (chunk, combine and zero kernels
# in one C call count once), likewise, in all and per form of the walk
# (reset with ``dict.fromkeys(BWD_FORMS, 0)``).
bwd_launch_count = 0
bwd_launch_counts = dict.fromkeys(BWD_FORMS, 0)
# What the last build did: seconds spent in nvcc (0.0 when the library
# was already built) and the compiler's report (registers, spills).
build_seconds = 0.0
build_log = ""

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C functions' argument types on a loaded B2 library."""
    for fn in (lib.embedding_bag_fwd, lib.embedding_bag_bwd):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once per source hash, ``kernels/_build.py``) and load the
    kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, built = _build.load(SOURCE)
    build_seconds, build_log = built.seconds, built.log
    _lib = bind(lib)
    return _lib


@functools.cache
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a card, asked once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def geometry(num_bags: int, d: int, element_size: int
             ) -> tuple[int, int, int]:
    """(columns per thread, threads per bag, blocks) of a launch with
    one bag per group: each thread loads 16 bytes of a row (4
    float32 or 8 bfloat16 columns), a bag takes ceil(d / columns) threads
    up to a whole block, and a block of ``THREADS`` holds ``THREADS //
    group`` bags. ``persistent_blocks`` caps the blocks to the resident
    ones; each then strides over the bags."""
    vec = 16 // element_size
    group = min(-(-d // vec), THREADS)
    return vec, group, -(-num_bags // (THREADS // group))


def persistent_blocks(blocks: int, sms: int) -> int:
    """The persistent grid of a launch: ``geometry``'s blocks, at most
    the card's resident blocks."""
    return max(1, min(blocks, sms * BLOCKS_PER_SM))


def _check_table(table: torch.Tensor) -> None:
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"table must be (V, d) with V >= 1; got "
                         f"{tuple(table.shape)}")
    if table.dtype not in TABLE_DTYPES:
        raise TypeError(f"table must be float32 or bfloat16; got "
                        f"{table.dtype}")


def _check(table: torch.Tensor, idx: torch.Tensor,
           weights: torch.Tensor | None) -> None:
    _check_table(table)
    i_shape = idx.shape
    if len(i_shape) != 2:
        raise ValueError(f"idx must be (B, L); got {tuple(i_shape)}")
    if idx.dtype not in ID_DTYPES:
        raise TypeError(f"idx must be int32 or int64; got {idx.dtype}")
    dev = table.device
    if weights is None:
        if idx.device != dev:
            raise ValueError(f"table, idx and weights must share one "
                             f"device; got {dev}, {idx.device}")
        return
    if weights.shape != i_shape:
        raise ValueError(f"weights {tuple(weights.shape)} must have the "
                         f"shape of idx {tuple(i_shape)}")
    if not weights.is_floating_point():
        raise TypeError(f"weights must be floating point; got "
                        f"{weights.dtype}")
    if idx.device != dev or weights.device != dev:
        raise ValueError(f"table, idx and weights must share one device; "
                         f"got {dev}, {idx.device}, {weights.device}")


def launch_args(table: torch.Tensor, idx: torch.Tensor,
                bags: tuple[int, int], idx_strides: tuple[int, int],
                w: torch.Tensor | None, out: torch.Tensor, group: int,
                blocks: int) -> bytes:
    """The packed C arguments of one launch (``ARGS`` order): ``bags``
    (B, L) ids read from ``idx`` through ``idx_strides``."""
    v, d = table.shape
    w_ptr, w_sb, w_sl = (0, 0, 0) if w is None else (w.data_ptr(),
                                                     *w.stride())
    return ARGS.pack(int(table.dtype == torch.bfloat16),
                     int(idx.dtype == torch.int64), table.data_ptr(), v,
                     table.stride(0), idx.data_ptr(), *idx_strides, w_ptr,
                     w_sb, w_sl, out.data_ptr(), *bags, d, group, blocks)


def _launch_bags(table: torch.Tensor, idx: torch.Tensor,
                 bags: tuple[int, int], idx_strides: tuple[int, int],
                 weights: torch.Tensor | None,
                 out: torch.Tensor) -> torch.Tensor:
    """Launch B2 on the card for ``bags`` (B, L) read from ``idx``
    through ``idx_strides`` into ``out`` (B * d contiguous values), or
    raise on what the kernel cannot take."""
    global launch_count
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _launch.check_hopper(dev, "embedding bag")
    d = table.shape[1]
    b, l = bags
    if table.stride(1) != 1:
        raise ValueError("table must have a contiguous last dimension")
    if l >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: L={l}, d={d}")
    if b == 0 or d == 0:
        return out
    _, group, blocks = geometry(b, d, table.element_size())
    blocks = persistent_blocks(blocks, sm_count(dev))
    w = None if weights is None else weights.to(torch.float32)
    args = launch_args(table, idx, bags, idx_strides, w, out, group, blocks)
    lib = load_library()
    with _launch.device_guard(dev):
        err = lib.embedding_bag_fwd(args, _launch.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"embedding bag kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return out


def embedding_bag_cuda(table: torch.Tensor, idx: torch.Tensor,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """table (V, d) float32 or bfloat16; idx (B, L) int32 or int64 (pad:
    any id >= V); weights (B, L) or None -> (B, d) in the table's dtype.

    The counterpart of the JAX package's ``embedding_bag_pallas`` without
    its padding. CUDA tensors go to the kernel (or raise); CPU tensors go
    to the plain version.
    """
    _check(table, idx, weights)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, idx, weights)
    out = table.new_empty((idx.shape[0], table.shape[1]))
    return _launch_bags(table, idx, idx.shape, idx.stride(), weights, out)


def embedding_lookup_cuda(table: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """table (V, d); ids (...) int32 or int64 -> rows (..., d): each id a
    one-id bag (zeros for an id >= V, row 0 for an id < 0). On the card
    one B2 launch writes an output of the final shape, so neither the ids
    nor the rows are reshaped; CPU tensors go to the plain version."""
    _check_table(table)
    if ids.dtype not in ID_DTYPES:
        raise TypeError(f"ids must be int32 or int64; got {ids.dtype}")
    if ids.device != table.device:
        raise ValueError(f"table and ids must share one device; got "
                         f"{table.device}, {ids.device}")
    d = table.shape[1]
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids.reshape(-1, 1)).reshape(
            *ids.shape, d)
    if not ids.is_contiguous():
        ids = ids.contiguous()
    out = table.new_empty((*ids.shape, d))
    return _launch_bags(table, ids, (ids.numel(), 1), (1, 0), None, out)


@dataclasses.dataclass(frozen=True)
class BwdGeometry:
    """The backward's grid. A team of ``team`` threads, one 16-byte
    column chunk each, owns one (chunk, slab) of ``slab_cols`` columns;
    a block of ``threads`` holds ``cpb`` chunks x ``spb`` slabs; the grid
    is ``grid_x`` chunk groups x ``grid_y`` slab groups."""
    team: int
    slab_cols: int
    slabs: int
    cpb: int
    spb: int
    threads: int
    grid_x: int
    grid_y: int


def bwd_geometry(n_chunks: int, d: int, element_size: int) -> BwdGeometry:
    """A slab is what one warp covers at 16 bytes a thread (256 bfloat16
    or 128 float32 columns). Where d is no wider, one team of ceil(d /
    kVec) threads covers the row and ``THREADS // team`` chunks (at most
    ``BWD_MAX_CHUNKS_PER_BLOCK``) share a block: several chunks a warp,
    in a block of ``THREADS`` whatever the teams take: every thread
    stages the block's keys, rows and weights (``tools/b2_variants.py``
    times the fewest warps beside it). Wider rows take ceil(cols / 32)
    slabs, spread over as few slab groups of at most
    ``BWD_MAX_SLABS_PER_BLOCK`` as can hold them, and a block takes as
    many chunks as leave it within ``THREADS``."""
    vec = 16 // element_size
    cols = -(-d // vec)                       # 16-byte column chunks
    if cols <= 32:
        team, slabs, spb = cols, 1, 1
        cpb = min(THREADS // team, BWD_MAX_CHUNKS_PER_BLOCK)
    else:
        team, slabs = 32, -(-cols // 32)
        groups = -(-slabs // BWD_MAX_SLABS_PER_BLOCK)
        spb = -(-slabs // groups)
        cpb = max(1, BWD_MAX_SLABS_PER_BLOCK // spb)
    threads = (THREADS if slabs == 1
               else -(-(cpb * spb * team) // 32) * 32)
    return BwdGeometry(team, team * vec, slabs, cpb, spb, threads,
                       max(1, -(-n_chunks // cpb)), -(-slabs // spb))


def bwd_form(aligned: bool) -> str:
    """How the walk reads its dout slabs: "cp.async" (16-byte copies
    through the ring) where dout's base and rows are 16-byte aligned,
    else "sync" (plain loads)."""
    return "cp.async" if aligned else "sync"


def bwd_launch_args(dout: torch.Tensor, keys: torch.Tensor,
                    perm: torch.Tensor, w: torch.Tensor | None, bag_len: int,
                    grad: torch.Tensor, present: torch.Tensor,
                    partials: torch.Tensor, chunk: int, geo: BwdGeometry,
                    zero_blocks: int, form: str) -> bytes:
    """The packed C arguments of one backward call (``BWD_ARGS`` order)."""
    v, d = grad.shape
    return BWD_ARGS.pack(int(dout.dtype == torch.bfloat16), dout.data_ptr(),
                         keys.data_ptr(), perm.data_ptr(),
                         0 if w is None else w.data_ptr(), bag_len,
                         keys.numel(), v, d, grad.data_ptr(),
                         present.data_ptr(), partials.data_ptr(), chunk,
                         geo.team, geo.slab_cols, geo.cpb, geo.spb,
                         geo.threads, geo.grid_x, geo.grid_y, zero_blocks,
                         BWD_FORMS.index(form))


def embedding_bag_bwd_cuda(dout: torch.Tensor, idx: torch.Tensor,
                           weights: torch.Tensor | None,
                           num_rows: int) -> torch.Tensor:
    """dout (B, d) float32 or bfloat16 (the table's dtype); idx (B, L)
    int32 or int64 (pad: any id >= num_rows); weights (B, L) or None ->
    the table's (num_rows, d) gradient in dout's dtype: row r holds the
    sum of w[b,l] · dout[b] over the entries that read it (an id < 0
    reads row 0), every other row zero.

    CUDA tensors go to B2-bwd (or raise); CPU tensors go to the plain
    version (``ref.embedding_bag_bwd_ref``)."""
    global bwd_launch_count
    if dout.dim() != 2 or idx.dim() != 2 or dout.shape[0] != idx.shape[0]:
        raise ValueError(f"dout must be (B, d) and idx (B, L); got "
                         f"{tuple(dout.shape)}, {tuple(idx.shape)}")
    _check(dout, idx, weights)     # dout's dtype is the table's
    if not 1 <= num_rows < 2 ** 31:
        raise ValueError(f"num_rows must be in [1, 2**31); got {num_rows}")
    dev = dout.device
    if dev.type == "cpu":
        return embedding_bag_bwd_ref(dout, idx, weights, num_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _launch.check_hopper(dev, "embedding bag backward")
    d = dout.shape[1]
    n = idx.numel()
    if n >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: {n} entries, "
                         f"d={d}")
    es = dout.element_size()
    n_chunks = -(-n // BWD_CHUNK)
    geo = bwd_geometry(n_chunks, d, es)
    if geo.grid_y > 65535:
        raise ValueError(f"d={d} needs {geo.grid_y} slab groups, above the "
                         "grid's 65,535")
    dout = dout.contiguous()
    w = (None if weights is None
         else weights.to(torch.float32).contiguous())
    keys, perm = sorted_keys(idx, num_rows)
    zero_blocks = max(1, min(-(-num_rows // geo.cpb), ZERO_BLOCKS))
    form = bwd_form(dout.data_ptr() % 16 == 0 and d * es % 16 == 0)
    grad = dout.new_empty((num_rows, d))
    present = torch.zeros(num_rows, dtype=torch.uint8, device=dev)
    partials = torch.empty((max(n_chunks, 1), 2, d), dtype=torch.float32,
                           device=dev)
    lib = load_library()
    args = bwd_launch_args(dout, keys, perm, w, idx.shape[1], grad, present,
                           partials, BWD_CHUNK, geo, zero_blocks, form)
    with _launch.device_guard(dev):
        err = lib.embedding_bag_bwd(args, _launch.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"embedding bag backward launch failed: CUDA "
                           f"error {err}")
    bwd_launch_count += 1
    bwd_launch_counts[form] += 1
    return grad
