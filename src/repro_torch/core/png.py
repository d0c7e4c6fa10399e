"""Bipartite Partition-Node Graph (PNG) layout — paper §IV-B.

The PNG build *compresses* (dedup per (source node, destination
partition)) and *transposes* (groups by destination partition) the edge
set in the paper's two merged scans. Host-side numpy pre-processing,
exactly like the paper's pre-processing step (§VI-D3); the output is a
set of flat arrays that the torch engines and the CUDA gather kernel
consume:

  update_src[U]        source node of each deduplicated update,
                       sorted by (dst_partition, src_partition, src)
  update_offsets[k+1]  update range per destination partition
  edge_update_idx[M]   per edge: index into the update stream
  edge_dst[M]          per edge: global destination node id
  edge_offsets[k+1]    edge range per destination partition

The per-edge gather stream is sorted by destination node id (which is
partition-major automatically, since partitions are contiguous ID
ranges). Sorted destinations make the gather phase's writes sequential
— the paper's cache-friendly partition-resident accumulation — and let
the device gather use the blocked segmented reduction of
``build_gather_schedule`` instead of an element-wise scatter-add.

The MSB/branch-avoidance trick (paper §IV-C) is replaced by the explicit
``edge_update_idx`` stream — same 4 B/edge, branch-free, full 2^32 ID
space.

Compression ratio r = M / U is the paper's central statistic (table V).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..graphs.formats import Graph, lexsort_order, lexsorted
from .partition import Partitioning


@dataclasses.dataclass(frozen=True)
class PNGLayout:
    partitioning: Partitioning
    update_src: np.ndarray       # (U,) int32
    update_offsets: np.ndarray   # (k+1,) int64
    edge_update_idx: np.ndarray  # (M,) int32
    edge_dst: np.ndarray         # (M,) int32
    edge_offsets: np.ndarray     # (k+1,) int64
    num_nodes: int
    num_edges: int

    @property
    def num_updates(self) -> int:
        return int(self.update_src.shape[0])

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    @property
    def compression_ratio(self) -> float:
        """r = |E| / |E'| (paper table V)."""
        return self.num_edges / max(self.num_updates, 1)

    # ------------------------------------------------------- comm model
    def model_bytes(self, *, d_i: int = 4, d_v: int = 4) -> dict:
        """Per-iteration DRAM/HBM byte model, eq. (5) of the paper,
        instantiated with the *actual* U and M of this layout."""
        n, m, u, k = (self.num_nodes, self.num_edges, self.num_updates,
                      self.num_partitions)
        scatter = n * d_v + u * d_v + (k * k + u) * d_i
        gather = m * d_i + u * d_v + n * d_v
        return {"scatter": scatter, "gather": gather,
                "total": scatter + gather}


def build_png(g: Graph, part: Partitioning) -> PNGLayout:
    """Merged compress+transpose build (paper §IV-B, two scans)."""
    dstp = (g.dst.astype(np.int64) // part.part_size)
    # Scan 1: sort edges by (dst_partition, src, dst) — the transposed,
    # destination-partition-major order the scatter phase streams in.
    dstp_s, src_s, dst_s = lexsorted(dstp, g.src, g.dst)
    # Scan 2: dedup (dst_partition, src) pairs → the update stream.
    pair_key = dstp_s * np.int64(g.num_nodes) + src_s
    # pair_key is already sorted (lexsort above) → run-length dedup.
    new_update = np.empty(len(pair_key), dtype=bool)
    if len(pair_key):
        new_update[0] = True
        np.not_equal(pair_key[1:], pair_key[:-1], out=new_update[1:])
    edge_update_idx = (np.cumsum(new_update) - 1).astype(np.int32)
    update_src = src_s[new_update].astype(np.int32)
    update_dstp = dstp_s[new_update]

    k = part.num_partitions
    update_offsets = np.zeros(k + 1, dtype=np.int64)
    np.add.at(update_offsets, update_dstp + 1, 1)
    np.cumsum(update_offsets, out=update_offsets)
    edge_offsets = np.zeros(k + 1, dtype=np.int64)
    np.add.at(edge_offsets, dstp_s + 1, 1)
    np.cumsum(edge_offsets, out=edge_offsets)

    # Re-sort the gather stream by destination node. Stable, so edges
    # stay grouped by destination partition (partition = dst // psz is
    # monotone in dst) and edge_offsets remain valid; edge_update_idx
    # still points at the same (unchanged) update stream.
    gorder = lexsort_order(dst_s)

    return PNGLayout(part, update_src, update_offsets,
                     edge_update_idx[gorder],
                     dst_s[gorder].astype(np.int32), edge_offsets,
                     g.num_nodes, g.num_edges)


# ---------------------------------------------------------------------------
# Blocked gather schedule — hierarchical segmented reduction.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GatherSchedule:
    """Precomputed schedule for the blocked gather phase.

    The dst-sorted edge stream is cut into fixed ``block``-sized chunks:
    a destination's contribution inside one chunk is a contiguous run,
    so it equals a difference of the chunk-local inclusive prefix sum —
    fully vectorized, and exact to f32 rounding because prefix
    magnitudes stay chunk-local. Runs are then combined with one small
    scatter-add over ``num_pieces ≈ n + M/block`` entries instead of M.

      edge_update_idx_padded[Mp]  update pointer, M padded to block mult
      piece_start[P0], piece_end[P0]   inclusive run bounds (flat index)
      piece_dst[P0]               global destination, pad = num_nodes
    """
    block: int
    num_edges: int               # un-padded M
    edge_update_idx_padded: np.ndarray  # (Mp,) int32, pad = 0 (inert)
    piece_start: np.ndarray      # (P0,) int32
    piece_end: np.ndarray        # (P0,) int32
    piece_dst: np.ndarray        # (P0,) int32, pad = num_nodes

    @property
    def num_blocks(self) -> int:
        return len(self.edge_update_idx_padded) // self.block


def flat_gather_schedule(edge_update_idx: np.ndarray,
                         edge_dst: np.ndarray, *, num_nodes: int,
                         block: int = 256, pad_update: int = 0
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
    """Schedule-build core over raw dst-sorted streams.

    Returns ``(eui_padded, piece_start, piece_end, piece_dst)`` with
    the stream padded to a ``block`` multiple; pad edges point at
    ``pad_update`` and carry the ``num_nodes`` sentinel destination so
    the final segment-sum drops them.
    """
    m = len(edge_dst)
    mp = -(-max(m, 1) // block) * block
    dst_pad = np.full(mp, num_nodes, dtype=np.int32)
    dst_pad[:m] = edge_dst
    eui_pad = np.full(mp, pad_update, dtype=np.int32)
    eui_pad[:m] = edge_update_idx

    new_piece = np.empty(mp, dtype=bool)
    new_piece[0] = True
    np.not_equal(dst_pad[1:], dst_pad[:-1], out=new_piece[1:])
    new_piece[::block] = True
    starts = np.flatnonzero(new_piece).astype(np.int32)
    ends = np.append(starts[1:], mp).astype(np.int32) - 1
    return eui_pad, starts, ends, dst_pad[starts]


def build_gather_schedule(layout: PNGLayout, *,
                          block: int = 256) -> GatherSchedule:
    """Cut the dst-sorted gather stream into per-block runs.

    A new piece starts wherever the destination changes or a block
    boundary is crossed; pad edges (index >= M) point at update 0 but
    carry the ``num_nodes`` sentinel destination, so the final
    segment-sum drops them.
    """
    eui_pad, starts, ends, piece_dst = flat_gather_schedule(
        layout.edge_update_idx, layout.edge_dst,
        num_nodes=layout.num_nodes, block=block, pad_update=0)
    return GatherSchedule(block, layout.num_edges, eui_pad, starts,
                          ends, piece_dst)


# ---------------------------------------------------------------------------
# Blocked (per-partition padded) view — execution schedule of the paper &
# input format of the CUDA gather kernel.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockedPNG:
    """PNG re-laid-out as dense (k, max_*) blocks with padding.

    Pad entries have update value slot U (an extra zero row) and dst_local
    slot part_size (an extra accumulator row) so they are mathematically
    inert without branches.
    """
    part_size: int
    update_src: np.ndarray       # (k, max_u) int32, pad = -1
    edge_update_local: np.ndarray  # (k, max_e) int32 into partition updates,
                                   # pad = max_u (extra zero row)
    edge_dst_local: np.ndarray   # (k, max_e) int32, pad = part_size
    update_pad_frac: float
    edge_pad_frac: float


def block_png(layout: PNGLayout) -> BlockedPNG:
    """Vectorized re-layout: one scatter per stream, no per-partition
    Python loop (preprocessing time is a paper headline, table VII)."""
    k = layout.num_partitions
    psz = layout.partitioning.part_size
    u_cnt = np.diff(layout.update_offsets)
    e_cnt = np.diff(layout.edge_offsets)
    max_u = max(int(u_cnt.max(initial=0)), 1)
    max_e = max(int(e_cnt.max(initial=0)), 1)
    up = np.full((k, max_u), -1, dtype=np.int32)
    eu = np.full((k, max_e), max_u, dtype=np.int32)
    ed = np.full((k, max_e), psz, dtype=np.int32)
    # partition id + within-partition position of every update / edge
    part_u = np.repeat(np.arange(k), u_cnt)
    pos_u = np.arange(layout.num_updates) - layout.update_offsets[part_u]
    part_e = np.repeat(np.arange(k), e_cnt)
    pos_e = np.arange(layout.num_edges) - layout.edge_offsets[part_e]
    up[part_u, pos_u] = layout.update_src
    eu[part_e, pos_e] = (layout.edge_update_idx
                         - layout.update_offsets[part_e])
    ed[part_e, pos_e] = layout.edge_dst - part_e * psz
    u_pad = 1.0 - layout.num_updates / max(k * max_u, 1)
    e_pad = 1.0 - layout.num_edges / max(k * max_e, 1)
    return BlockedPNG(psz, up, eu, ed, u_pad, e_pad)
