"""PNG + feature matrix -> full PCPM SpMV through the gather kernel.
On B1's "tile" path (d = 1, ``pcpm_spmv_tile``) the scatter phase is a
torch gather producing the bins, as it was an XLA gather in the JAX
package; on its "warp" path (``pcpm_spmv_pallas``) the kernel reads
``x[update_src]`` itself (the fused form, ``kernel.pcpm_spmv_cuda``) and
no bins exist.

Two device layouts of one plan's gather streams: ``PackedPNG``, the
reference's blocked (k, n_eb, Eb) streams in destination order, every
partition padded to the heaviest one (B1's "warp" path, any d), and
``TileSchedule``, the port's own gather order for d = 1, built from the
PNG's streams (B1's "tile" path): each partition's real edges ordered by
(destination tile, update, destination), cut into a chunk table, read
with the PNG's own (U,) updates; it pads nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.png import BlockedPNG, PNGLayout
from ...device import resolve_device
from .kernel import pcpm_spmv_cuda, tile_gather_cuda

# shared memory of one "tile" block, which sets the tile size: two such
# blocks fit an SM (228 KB, 1 KB of it reserved per block)
TILE_BYTES = 96 * 1024
SM_SHARED_BYTES = 228 * 1024
H100_SMS = 132
# destinations of each tile summed in registers (tile::kHubs in the source)
HUBS = 8


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class PackedPNG:
    """Kernel-ready PNG blocks (device tensors)."""
    part_size: int
    num_nodes: int
    update_src: torch.Tensor    # (k, U) int32, pad -> 0 (never read)
    update_valid: torch.Tensor  # (k, U) bool, unused by the SpMV
    edge_upd: torch.Tensor      # (k, n_eb, Eb) int32, pad -> U
    edge_dst: torch.Tensor      # (k, n_eb, Eb) int32, pad -> part_size

    @property
    def num_partitions(self) -> int:
        return self.update_src.shape[0]


def pack_blocked(blocked: BlockedPNG, num_nodes: int, *,
                 edge_block: int = 512, lane: int = 1,
                 device=None) -> PackedPNG:
    """Pad the blocked PNG to whole edge blocks and upload it.

    The JAX package rounds U up to the TPU's 128 lanes (its ``lane``
    argument); the card needs no such padding, so ``lane`` defaults to
    1, with which both packages give equal arrays.
    """
    dev = resolve_device(device)
    k, max_u = blocked.update_src.shape
    _, max_e = blocked.edge_update_local.shape
    u_pad = _round_up(max(max_u, lane), lane)
    e_pad = _round_up(max(max_e, edge_block), edge_block)

    upd = np.zeros((k, u_pad), dtype=np.int32)
    valid = np.zeros((k, u_pad), dtype=bool)
    upd[:, :max_u] = np.maximum(blocked.update_src, 0)
    valid[:, :max_u] = blocked.update_src >= 0

    eu = np.full((k, e_pad), u_pad, dtype=np.int32)
    ed = np.full((k, e_pad), blocked.part_size, dtype=np.int32)
    eu[:, :max_e] = np.where(blocked.edge_update_local >= max_u, u_pad,
                             blocked.edge_update_local)
    ed[:, :max_e] = blocked.edge_dst_local

    n_eb = e_pad // edge_block
    return PackedPNG(
        blocked.part_size, num_nodes,
        torch.from_numpy(upd).to(dev), torch.from_numpy(valid).to(dev),
        torch.from_numpy(eu.reshape(k, n_eb, edge_block)).to(dev),
        torch.from_numpy(ed.reshape(k, n_eb, edge_block)).to(dev))


@dataclasses.dataclass(frozen=True)
class TileSchedule:
    """The gather order of kernel B1's "tile" path (d = 1).

    ``edge_upd``/``edge_dst`` hold every real edge of every partition,
    partition after partition, each partition's ordered by (destination
    tile, update, destination): the paper's (partition, src, dst) order
    cut into tiles of ``tile`` destinations. No pad slot is stored.
    ``chunks`` rows are (partition, tile index, first edge, end edge),
    each inside one tile; block b of the launch walks chunks
    ``block_chunks[b] .. block_chunks[b + 1] - 1``. ``hubs`` row
    ``p * n_tiles + t`` names tile t's heaviest destinations (tile-local,
    distinct, -1 for none), which the kernel sums in registers. The tables
    are checked here, once: the kernel trusts them (each edge's values it
    checks itself).
    """
    part_size: int
    num_partitions: int
    tile: int                   # destinations per tile, a multiple of 4
    edge_upd: torch.Tensor      # (M,) int32, partition-local update
    edge_dst: torch.Tensor      # (M,) int32, partition-local destination
    chunks: torch.Tensor        # (N, 4) int32
    block_chunks: torch.Tensor  # (blocks + 1,) int32
    hubs: torch.Tensor          # (k * n_tiles, HUBS) int32

    def __post_init__(self):
        m = self.edge_upd.shape[0]
        for name, t in (("edge_upd", self.edge_upd),
                        ("edge_dst", self.edge_dst),
                        ("chunks", self.chunks),
                        ("block_chunks", self.block_chunks),
                        ("hubs", self.hubs)):
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError(f"TileSchedule.{name} must be contiguous "
                                 f"int32; got {t.dtype}")
            if t.device != self.edge_upd.device:
                raise ValueError("TileSchedule tensors must share a device")
            if t.device.type == "cuda" and t.data_ptr() % 16:
                raise ValueError(f"TileSchedule.{name} must be 16-byte "
                                 "aligned on the card")
        if self.edge_dst.shape != (m,) or self.edge_upd.dim() != 1:
            raise ValueError("TileSchedule streams must be (M,) alike")
        if m >= 2 ** 31 or self.tile < 4 or self.tile % 4:
            raise ValueError(f"TileSchedule: M={m} (max 2**31 - 1), tile "
                             f"{self.tile} (a multiple of 4)")
        chunks = self.chunks.cpu().long()
        starts = self.block_chunks.cpu().long()
        if chunks.dim() != 2 or chunks.shape[1] != 4 or starts.dim() != 1:
            raise ValueError("TileSchedule.chunks must be (N, 4) and "
                             "block_chunks (blocks + 1,)")
        p, t, first, end = chunks.unbind(1)
        if not (bool(((p >= 0) & (p < self.num_partitions) & (t >= 0)
                      & (t * self.tile < self.part_size) & (first >= 0)
                      & (first <= end) & (end <= m)).all())
                and len(starts) >= 1 and int(starts[0]) == 0
                and int(starts[-1]) == len(chunks)
                and bool((starts[1:] >= starts[:-1]).all())):
            raise ValueError("TileSchedule: chunk table out of range")
        hubs = self.hubs.cpu().long()
        n_seg = self.num_partitions * -(-self.part_size // self.tile)
        if hubs.shape != (n_seg, HUBS):
            raise ValueError(f"TileSchedule.hubs must be ({n_seg}, {HUBS}); "
                             f"got {tuple(hubs.shape)}")
        ordered = hubs.sort(1).values
        if not (bool(((hubs >= -1) & (hubs < self.tile)).all())
                and bool(((ordered[:, 1:] != ordered[:, :-1])
                          | (ordered[:, 1:] < 0)).all())):
            raise ValueError("TileSchedule: hub table out of range or "
                             "repeating a destination")

    @property
    def blocks(self) -> int:
        return self.block_chunks.shape[0] - 1

    @property
    def nbytes(self) -> int:
        """Device bytes of its tensors."""
        return sum(t.numel() * t.element_size()
                   for t in (self.edge_upd, self.edge_dst, self.chunks,
                             self.block_chunks, self.hubs))


def tile_size(part_size: int, tile_bytes: int = TILE_BYTES) -> int:
    """Destinations per tile at d = 1: the partition cut into the fewest
    tiles of at most ``tile_bytes`` of float32, made equal and rounded up
    to a multiple of 4 (the kernel zeroes and flushes 16 bytes at a
    time)."""
    n_tiles = -(-part_size * 4 // tile_bytes)
    return min(_round_up(-(-part_size // n_tiles), 4), tile_bytes // 4)


def tile_blocks(device: torch.device, tile_bytes: int = TILE_BYTES) -> int:
    """Blocks of one "tile" launch: as many as the card holds at once (its
    SMs times the blocks whose shared memory fits one SM), so that the
    equal shares of edges run in one wave. An H100's count for a CPU
    device, whose schedule only the plain version reads."""
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else H100_SMS)
    per_sm = max(1, SM_SHARED_BYTES // (tile_bytes + 1024))
    return sms * per_sm


def tile_hubs(seg: np.ndarray, jt: np.ndarray, n_seg: int,
              tile: int) -> np.ndarray:
    """(n_seg, HUBS) int32: the heaviest destinations of each tile, by
    falling edge count (ties: the lower id), given each edge's segment
    (partition * n_tiles + tile) and tile-local destination; -1 where a
    tile has fewer destinations of two or more edges."""
    counts = np.bincount(seg.astype(np.int64) * tile + jt,
                         minlength=n_seg * tile).reshape(n_seg, tile)
    h = min(HUBS, tile)
    top = np.argsort(-counts, axis=1, kind="stable")[:, :h]
    hubs = np.full((n_seg, HUBS), -1, dtype=np.int32)
    hubs[:, :h] = np.where(np.take_along_axis(counts, top, 1) >= 2, top, -1)
    return hubs


def tile_schedule(png: PNGLayout, *, tile_bytes: int = TILE_BYTES,
                  blocks: int | None = None, device=None) -> TileSchedule:
    """The "tile" path's gather order of a PNG, on ``device``, from its
    own streams in O(m): the sort keys of its edges (``edge_keys``) cut
    into chunks (``order_keys``)."""
    dev = resolve_device(device)
    if blocks is None:
        blocks = tile_blocks(dev, tile_bytes)
    psz = png.partitioning.part_size
    k = png.num_partitions
    num_updates = max(int(np.diff(png.update_offsets).max(initial=0)), 1)
    tile = tile_size(psz, tile_bytes)
    part = np.repeat(np.arange(k), np.diff(png.edge_offsets))
    key = edge_keys(part, png.edge_update_idx - png.update_offsets[part],
                    png.edge_dst - part * psz, k=k, psz=psz,
                    num_updates=num_updates, tile=tile)
    del part
    return order_keys(key, k=k, psz=psz, num_updates=num_updates, tile=tile,
                      blocks=blocks, device=dev)


def edge_keys(part: np.ndarray, u: np.ndarray, j: np.ndarray, *, k: int,
              psz: int, num_updates: int, tile: int) -> np.ndarray:
    """The 64-bit sort key (partition, tile, update, destination) of each
    real edge of ``k`` partitions of ``psz`` destinations, from its
    partition ``part``, partition-local update ``u`` (below
    ``num_updates``) and partition-local destination ``j``."""
    n_tiles = -(-psz // tile)
    if k * n_tiles * num_updates * psz >= 2 ** 63:
        raise ValueError("tile_schedule: sort key out of 64 bits")
    u = np.asarray(u, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    return ((part * n_tiles + j // tile) * num_updates + u) * psz + j


def order_keys(key: np.ndarray, *, k: int, psz: int, num_updates: int,
               tile: int, blocks: int, device: torch.device) -> TileSchedule:
    """The gather order, on ``device``, of the edges whose ``edge_keys``
    are ``key`` (sorted here, in place).

    Host numpy, once per plan: one sort of the keys. The ordered stream
    is cut into ``blocks`` equal ranges and at every tile's bounds; each
    piece is a chunk. Each tile's ``HUBS`` heaviest destinations are its
    hubs (``tile_hubs``).
    """
    n_tiles = -(-psz // tile)
    key.sort()
    edge_dst = (key % psz).astype(np.int32)
    key //= psz
    edge_upd = (key % num_updates).astype(np.int32)
    seg = key // num_updates                     # partition * n_tiles + tile
    m = len(seg)
    seg_bounds = np.searchsorted(seg, np.arange(k * n_tiles + 1))
    block_bounds = np.arange(blocks + 1, dtype=np.int64) * m // blocks
    bounds = np.union1d(seg_bounds, block_bounds)
    first, end = bounds[:-1], bounds[1:]
    first, end = first[end > first], end[end > first]
    seg_of = np.searchsorted(seg_bounds, first, side="right") - 1
    block_of = np.searchsorted(block_bounds, first, side="right") - 1
    chunks = np.stack([seg_of // n_tiles, seg_of % n_tiles, first, end],
                      axis=1).astype(np.int32)
    block_chunks = np.searchsorted(block_of, np.arange(blocks + 1))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    hubs = tile_hubs(seg, edge_dst - (seg % n_tiles) * tile, k * n_tiles,
                     tile)
    return TileSchedule(psz, k, tile, up(edge_upd), up(edge_dst),
                        up(chunks.reshape(-1, 4)), up(block_chunks),
                        up(hubs))


def pcpm_spmv_pallas(packed: PackedPNG, x: torch.Tensor) -> torch.Tensor:
    """y = A^T x. x: (n,) or (n, d) with any d >= 1, on the device the
    packed layout lives on.

    The name is the JAX package's (``ops.pcpm_spmv_pallas``), kept so
    the counterpart is easy to find; on the card the gather runs the
    CUDA kernel's "warp" path in its fused form, which reads
    ``x[update_src]`` inside the kernel, so no (k, U, d) bins tensor is
    made, and d is not padded. A plan's d = 1 SpMV takes B1's "tile"
    path instead (``pcpm_spmv_tile``).

    The JAX version zeroes the pad update slots (``* update_valid``);
    here that pass is left out because no edge reads those slots: real
    edges point at real updates, and ``pack_blocked`` points pad edges
    at ``U``, which the gather drops.
    """
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    n, d = x.shape
    out = pcpm_spmv_cuda(x.contiguous(), packed.update_src, packed.edge_upd,
                         packed.edge_dst, part_size=packed.part_size)
    y = out.view(-1, d)[:n]
    return y[:, 0] if squeeze else y


def pcpm_spmv_tile(x: torch.Tensor, update_src: torch.Tensor,
                   update_offsets: torch.Tensor,
                   schedule: TileSchedule) -> torch.Tensor:
    """y = A^T x for x (n,) or (n, 1) through B1's "tile" path over a
    PNG's own streams: ``update_src`` (U,) int32 and ``update_offsets``
    (k + 1,) int32, the PNG's, on the device, and ``schedule`` built from
    the same PNG (``tile_schedule``). The scatter phase gathers the bins
    ``x[update_src]``, U values with no pad, partition p's from
    ``update_offsets[p]``; the gather reads each from there
    (``kernel.tile_gather_cuda``). Nothing is padded to the heaviest
    partition, which a hub-first labeling makes over ten times the mean.
    """
    bins = x.reshape(-1).index_select(0, update_src)
    out = tile_gather_cuda(bins, update_offsets, schedule)
    return out.view(-1)[:x.shape[0]].view(x.shape)
