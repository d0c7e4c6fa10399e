"""Distributed PCPM on ``torch.distributed``: the paper's
communication-volume reduction lifted from DRAM traffic to the wire
between cards (the JAX package's ``core/distributed.py``; DESIGN.md §6).

Vertices are sharded contiguously over S ranks. The PNG build at shard
granularity gives, per (source shard s, destination shard t), the
DEDUPLICATED update list: each source vertex's value crosses the wire
once per destination shard instead of once per cross-shard edge
(compression r on the wire). The scatter phase is one all-to-all of
dense compressed buffers; the gather phase is the shard-local blocked
reduction of DESIGN.md §3 over a dst-sorted edge stream.

The JAX package drives a mesh of S devices from one process under
``shard_map``. PyTorch scales the other way: one process per card, each
holding one shard, with the collectives of ``torch.distributed``.

- **The mesh** (``ShardMesh``) is the first S ranks of the default
  group: that group itself when S is the world size, else a
  ``dist.new_group`` that every rank creates. The caller initializes the
  default group (``init_process_group``, the usual torchrun way) and
  sets each rank's CUDA device; this module never does. Without an
  initialized group only one shard is possible, and its all-to-all is
  the identity copy a 1-way all-to-all is.
- **Data.** The public functions take and return full padded vectors
  (``(n_pad,)`` or ``(n_pad, d)``, ``n_pad = S * shard_size``) on every
  rank, as the JAX package's global arrays are. Inside the loops each
  rank keeps only its ``shard_size`` rows. What crosses ranks: one
  ``all_to_all_single`` of the (S, U, d) send buffers per SpMV; one
  ``all_reduce`` of the per-column L1 residual per checked iteration;
  one ``all_reduce`` of the dangling mass per iteration under
  ``dangling="redistribute"``; the final gather of the result. Ranks
  outside the mesh take a one-shot result from rank 0 by one broadcast.
- **Decisions** (the early exit, a column's freeze) are read from
  all-reduced values only, so every rank decides the same way and no
  rank waits in a collective the others skipped. Host reads follow the
  single-device fused driver: none with ``tol == 0``, one all-reduced
  scalar per check with ``tol > 0``; the chunk stepper reads
  ``active.any()`` once per iteration.
- **SPMD contract.** Every rank makes the same calls in the same order
  (the same plans, solves, submits, steps and deltas); results are then
  identical on every rank.
- Each mesh counts its collective calls by name (``ShardMesh.counts``),
  so a caller can assert that an SpMV went over the wire exactly once.

``ShardedPNG`` is a plan-layer artifact: the ``pcpm_sharded`` backend
(core/backends.py) builds it into the process-cached ``GraphPlan``
(core/plan.py), which also serializes it in the JAX package's format.
``edge_cut_spmv`` is the distributed BVGAS analogue (one update PER
EDGE on the wire), the communication baseline.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..graphs.formats import Graph, lexsort_order
from .png import flat_gather_schedule
from .spmv import _segment_sum, pcpm_gather_blocked

# the module, not the function ``core.pagerank`` that the package's
# ``__init__`` exports under the same name: the stepper's host read goes
# through ``pagerank._host_any``, which tests count
pagerank_mod = importlib.import_module(".pagerank", __package__)


# ---------------------------------------------------------------- layout
@dataclasses.dataclass(frozen=True)
class ShardedPNG:
    """Static-shape sharded PNG (leading axis = owning shard).

    send_ids  (S, S, U) int32: send_ids[s, t] = local ids shard s sends
                               to shard t (pad -1 -> zero value)
    edge_upd  (S, E) int32:    per dst shard, index into its receive
                               buffer (concat over s, row-major), pad
                               points at S*U (zero slot); dst-sorted
                               within each shard
    edge_dst  (S, E) int32:    local destination ids, ascending per
                               shard, pad = shard_size

    plus the per-shard blocked gather schedule (DESIGN.md §3 applied
    shard-locally): the dst-sorted stream padded to a ``gather_block``
    multiple and cut into contiguous same-destination runs.
    """
    num_shards: int
    shard_size: int
    num_nodes: int
    send_ids: np.ndarray
    edge_upd: np.ndarray
    edge_dst: np.ndarray
    # blocked gather schedule, per shard
    gather_block: int
    eui_padded: np.ndarray     # (S, Mp) int32, pad -> S*U zero slot
    piece_start: np.ndarray    # (S, P0) int32
    piece_end: np.ndarray      # (S, P0) int32
    piece_dst: np.ndarray      # (S, P0) int32, pad = shard_size
    # stats
    wire_updates: int      # deduplicated cross-shard update count (PCPM)
    wire_edges: int        # cross-shard edge count (edge-cut baseline)

    @property
    def wire_compression(self) -> float:
        return self.wire_edges / max(self.wire_updates, 1)

    @property
    def padded_nodes(self) -> int:
        return self.num_shards * self.shard_size


def build_sharded_png(g: Graph, num_shards: int, *,
                      gather_block: int = 256) -> ShardedPNG:
    """The sharded layout of ``g`` over ``num_shards`` contiguous vertex
    shards (host numpy; every array equal to the JAX package's)."""
    shard_size = -(-g.num_nodes // num_shards)
    src = g.src.astype(np.int64)
    dst = g.dst.astype(np.int64)
    s_sh = src // shard_size
    d_sh = dst // shard_size

    # --- dedup (src, dst_shard) pairs, grouped by (src_shard, dst_shard)
    order = lexsort_order(d_sh, s_sh, src)
    src_o, dst_o, ssh_o, dsh_o = (src[order], dst[order], s_sh[order],
                                  d_sh[order])
    pair_key = (dsh_o * num_shards + ssh_o) * g.num_nodes + src_o
    new = np.empty(len(pair_key), dtype=bool)
    if len(pair_key):
        new[0] = True
        np.not_equal(pair_key[1:], pair_key[:-1], out=new[1:])
    # rank of each update within its (s, t) group
    grp_key = dsh_o * num_shards + ssh_o
    upd_idx_global = np.cumsum(new) - 1
    grp_of_upd = grp_key[new]
    grp_first_upd = np.zeros(grp_of_upd.shape[0], dtype=np.int64)
    if len(grp_of_upd):
        starts = np.flatnonzero(np.r_[True, grp_of_upd[1:]
                                      != grp_of_upd[:-1]])
        sizes = np.diff(np.r_[starts, len(grp_of_upd)])
        grp_first_upd = np.repeat(
            np.arange(len(grp_of_upd))[starts], sizes)
    upd_rank = np.arange(len(grp_of_upd)) - grp_first_upd

    counts = np.zeros(num_shards * num_shards, dtype=np.int64)
    np.add.at(counts, grp_of_upd, 1)
    u_max = max(int(counts.max(initial=0)), 1)

    send_ids = np.full((num_shards, num_shards, u_max), -1, dtype=np.int32)
    upd_src = src_o[new]
    upd_ssh = ssh_o[new]
    upd_dsh = dsh_o[new]
    send_ids[upd_ssh, upd_dsh, upd_rank] = (upd_src
                                            - upd_ssh * shard_size)

    # --- per-dst-shard edge streams referencing the receive buffer.
    # Receive buffer at shard t: rows s = send_ids[s, t] -> flat s*U + r.
    upd_slot = upd_ssh * u_max + upd_rank          # slot within dst buffer
    edge_slot = upd_slot[upd_idx_global]           # per edge (sorted order)
    # re-sort the gather stream by destination within each shard, so the
    # shard-local gather can use the blocked run reduction; edge_slot
    # still points at the same receive slots
    gorder = lexsort_order(dsh_o, dst_o)
    dsh_g = dsh_o[gorder]
    dst_g = dst_o[gorder]
    slot_g = edge_slot[gorder]
    e_counts = np.zeros(num_shards, dtype=np.int64)
    np.add.at(e_counts, dsh_g, 1)
    e_max = max(int(e_counts.max(initial=0)), 1)
    zero_slot = num_shards * u_max
    edge_upd = np.full((num_shards, e_max), zero_slot, dtype=np.int32)
    edge_dst = np.full((num_shards, e_max), shard_size, dtype=np.int32)
    e_first = np.zeros(len(dsh_g), dtype=np.int64)
    if len(dsh_g):
        starts = np.flatnonzero(np.r_[True, dsh_g[1:] != dsh_g[:-1]])
        sizes = np.diff(np.r_[starts, len(dsh_g)])
        e_first = np.repeat(np.arange(len(dsh_g))[starts], sizes)
    e_rank = np.arange(len(dsh_g)) - e_first
    edge_upd[dsh_g, e_rank] = slot_g
    edge_dst[dsh_g, e_rank] = dst_g - dsh_g * shard_size

    # --- per-shard blocked gather schedule over the dst-sorted streams
    scheds = [flat_gather_schedule(edge_upd[s], edge_dst[s],
                                   num_nodes=shard_size,
                                   block=gather_block,
                                   pad_update=zero_slot)
              for s in range(num_shards)]
    p_max = max(len(sc[1]) for sc in scheds)
    eui_padded = np.stack([sc[0] for sc in scheds])
    piece_start = np.zeros((num_shards, p_max), dtype=np.int32)
    piece_end = np.zeros((num_shards, p_max), dtype=np.int32)
    piece_dst = np.full((num_shards, p_max), shard_size, dtype=np.int32)
    for s, (_, st, en, pd) in enumerate(scheds):
        # pad pieces re-read run [0, 0] but carry the sentinel dst, so
        # the segment-sum drops them
        piece_start[s, :len(st)] = st
        piece_end[s, :len(en)] = en
        piece_dst[s, :len(pd)] = pd

    wire_updates = int(np.sum(upd_ssh != upd_dsh))
    wire_edges = int(np.sum(s_sh != d_sh))
    return ShardedPNG(num_shards, shard_size, g.num_nodes,
                      send_ids, edge_upd, edge_dst,
                      gather_block, eui_padded, piece_start, piece_end,
                      piece_dst, wire_updates, wire_edges)


def pad_to_shards(x: np.ndarray, layout: ShardedPNG) -> np.ndarray:
    n_pad = layout.num_shards * layout.shard_size
    pad = n_pad - x.shape[0]
    width = ((0, pad),) + ((0, 0),) * (x.ndim - 1)
    return np.pad(x, width)


def _padded_inv_degree(g: Graph, layout: ShardedPNG) -> np.ndarray:
    out_deg = np.asarray(g.out_degree)
    inv = np.where(out_deg == 0, 0.0, 1.0 / np.maximum(out_deg, 1))
    return pad_to_shards(inv.astype(np.float32), layout)


def padded_inv_degree(g: Graph, layout: ShardedPNG,
                      device) -> torch.Tensor:
    """``_padded_inv_degree`` on ``device``, memoized on the graph per
    (padded size, device) like ``core.pagerank._inv_degree``: one host
    pass and one upload per graph. Callers never write into it."""
    key = f"_inv_degree_pad{layout.padded_nodes}_{torch.device(device)}"
    inv = g.__dict__.get(key)
    if inv is None:
        inv = torch.from_numpy(_padded_inv_degree(g, layout)).to(device)
        g.__dict__[key] = inv        # frozen-safe: dict write
    return inv


# ------------------------------------------------------------------ mesh
def _default_group():
    """The initialized default process group, or None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def available_devices() -> int:
    """The devices a sharded plan may span: the world size of the
    initialized default process group, or 1 without one."""
    return 1 if _default_group() is None else dist.get_world_size()


_all_gather_single = getattr(dist, "all_gather_single", None)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardMesh:
    """The ranks one sharded layout runs on.

    ``group`` is the process group of the first ``num_shards`` ranks
    (None only for one shard with no group initialized), ``ranks`` those
    ranks, ``shard`` this process's shard index (None when this rank is
    outside the mesh), ``device`` where its tensors live and ``axis`` the
    mesh axis name; ``world`` is the default group it was built under
    (``current`` is False once that group is destroyed). ``counts``
    counts the collective calls made through the mesh by name; the
    identity exchange of a mesh without a group counts as
    ``"identity_all_to_all"``."""
    group: Optional[Any]
    ranks: tuple
    shard: Optional[int]
    device: torch.device
    axis: str = "shards"
    world: Optional[Any] = None
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter, repr=False)
    # per-layout device streams of this rank's shard (``_cached_streams``)
    _streams: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_shards(self) -> int:
        return len(self.ranks)

    @property
    def world_size(self) -> int:
        return available_devices()

    @property
    def current(self) -> bool:
        return self.world is _default_group()

    def all_to_all(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        """Chunk t of ``inp`` (split on dim 0) to shard t; chunk s of
        ``out`` from shard s."""
        if self.group is None:
            # one shard and no process group: the identity copy that a
            # 1-way all-to-all is
            self.counts["identity_all_to_all"] += 1
            out.copy_(inp)
            return
        self.counts["all_to_all_single"] += 1
        dist.all_to_all_single(out, inp, group=self.group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the mesh, in place."""
        if self.group is not None:
            self.counts["all_reduce"] += 1
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, out: torch.Tensor, local: torch.Tensor) -> None:
        """``out`` = every shard's ``local`` rows, in shard order."""
        if self.group is None:
            out.copy_(local)
            return
        self.counts["all_gather"] += 1
        (_all_gather_single or dist.all_gather_into_tensor)(
            out, local, group=self.group)

    def barrier(self) -> None:
        """Every rank of the mesh waits for the others."""
        if self.group is not None:
            self.counts["barrier"] += 1
            dist.barrier(group=self.group)

    def share(self, t: torch.Tensor) -> torch.Tensor:
        """A one-shot result of the mesh on every rank of the world: one
        broadcast from rank 0 (always in the mesh) over the default
        group, made only when some rank is outside the mesh."""
        if self.group is not None and self.world_size > self.num_shards:
            self.counts["broadcast"] += 1
            dist.broadcast(t, src=0)
        return t


def build_mesh(num_shards: int, *, device, axis: str = "shards"
               ) -> ShardMesh:
    """The mesh of the first ``num_shards`` ranks of the default group.
    With a group of another size every rank must call this in the same
    order (``dist.new_group``). Raises ``ValueError`` when
    ``num_shards`` exceeds the available devices."""
    from .backends import check_device_count
    check_device_count(num_shards)
    device = torch.device(device)
    world = _default_group()
    if world is None:
        return ShardMesh(None, (0,), 0, device, axis)
    size, rank = dist.get_world_size(), dist.get_rank()
    ranks = tuple(range(num_shards))
    group = world if num_shards == size else dist.new_group(list(ranks))
    return ShardMesh(group, ranks, rank if rank < num_shards else None,
                     device, axis, world)


def _check_axis(mesh: ShardMesh, axis: Optional[str]) -> None:
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")


@dataclasses.dataclass(frozen=True)
class _Streams:
    """This rank's shard of a layout on its device: the send ids with
    pad -1 moved to the zero row ``shard_size``, the blocked gather
    schedule and the real-row mask (the flat streams of ``blocked=False``
    are uploaded apart, on first use: ``_flat_streams``)."""
    lo: int
    hi: int
    send: torch.Tensor          # (S * U,) int32
    eui: torch.Tensor
    piece_start: torch.Tensor
    piece_end: torch.Tensor
    piece_dst: torch.Tensor
    mask: torch.Tensor          # (shard_size,) float32, 0 on pad rows

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.send, self.eui, self.piece_start, self.piece_end,
            self.piece_dst, self.mask))


def _upload(a: np.ndarray, mesh: ShardMesh) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)


def _cached_streams(layout: ShardedPNG, mesh: ShardMesh, kind: str, make):
    """``make()``, once per (layout, mesh, kind); the layout is kept
    alive with its id."""
    key = (id(layout), kind)
    hit = mesh._streams.get(key)
    if hit is None:
        if mesh.shard is None:
            raise RuntimeError("this rank is outside the mesh: it holds "
                               "no shard")
        hit = mesh._streams[key] = (layout, make())
    return hit[1]


def _shard_streams(layout: ShardedPNG, mesh: ShardMesh) -> _Streams:
    """This rank's streams of the blocked path."""
    def make():
        s, ssz = mesh.shard, layout.shard_size
        send = layout.send_ids[s].reshape(-1)
        lo = s * ssz
        mask = np.zeros(ssz, dtype=np.float32)
        mask[:max(0, min(ssz, layout.num_nodes - lo))] = 1.0
        return _Streams(lo, lo + ssz,
                        _upload(np.where(send < 0, ssz, send), mesh),
                        *(_upload(a[s], mesh) for a in (
                            layout.eui_padded, layout.piece_start,
                            layout.piece_end, layout.piece_dst)),
                        _upload(mask, mesh))

    return _cached_streams(layout, mesh, "blocked", make)


def _flat_streams(layout: ShardedPNG, mesh: ShardMesh):
    """This rank's ``(edge_upd, edge_dst)``, for the flat segment-sum."""
    return _cached_streams(layout, mesh, "flat", lambda: (
        _upload(layout.edge_upd[mesh.shard], mesh),
        _upload(layout.edge_dst[mesh.shard], mesh)))


# --------------------------------------------------------------- engines
def _scatter_all_to_all(layout: ShardedPNG, mesh: ShardMesh, st: _Streams,
                        x_l: torch.Tensor) -> torch.Tensor:
    """Shard-local scatter and wire phase: gather this shard's dedup send
    buffers from its (shard_size, d) rows and all-to-all them. Returns
    the receive buffer (S*U + 1, d) with a trailing zero slot for pad
    edges; row s*U + r came from shard s."""
    s, u = layout.num_shards, layout.send_ids.shape[2]
    d = x_l.shape[1]
    rows = torch.cat([x_l, x_l.new_zeros(1, d)])   # row shard_size = 0
    bufs = rows.index_select(0, st.send)           # (S*U, d)
    recv = x_l.new_empty(s * u + 1, d)
    recv[-1] = 0
    mesh.all_to_all(recv[:s * u], bufs)
    return recv


def _local_spmv(layout: ShardedPNG, mesh: ShardMesh, st: _Streams, *,
                blocked: bool = True):
    """This shard's y_l = (A^T x)_l from its x rows: scatter, all-to-all
    and the shard-local gather."""
    ssz, blk = layout.shard_size, layout.gather_block
    if not blocked:
        edge_upd, edge_dst = _flat_streams(layout, mesh)

    def spmv(x_l: torch.Tensor) -> torch.Tensor:
        recv = _scatter_all_to_all(layout, mesh, st, x_l)
        if blocked:
            return pcpm_gather_blocked(recv, st.eui, st.piece_start,
                                       st.piece_end, st.piece_dst,
                                       num_nodes=ssz, block=blk)
        vals = recv.index_select(0, edge_upd)
        return _segment_sum(vals, edge_dst, ssz + 1)[:ssz]

    return spmv


def _gather_rows(mesh: ShardMesh, local: torch.Tensor,
                 n_pad: int) -> torch.Tensor:
    """The full (n_pad, ...) array from every shard's local rows, on
    every rank of the world."""
    out = local.new_empty((n_pad,) + tuple(local.shape[1:]))
    if mesh.shard is not None:
        mesh.all_gather(out, local.contiguous())
    return mesh.share(out)


def pcpm_all_to_all_spmv(layout: ShardedPNG, mesh: ShardMesh,
                         axis: Optional[str] = None, *,
                         blocked: bool = True):
    """Returns ``spmv(x) -> A^T x`` over full padded x ((n_pad,) or
    (n_pad, d), the same on every rank) giving the full padded result
    on every rank.

    ``blocked=True`` (default) runs the shard-local gather as the
    hierarchical blocked reduction over the dst-sorted stream
    (DESIGN.md §3); ``blocked=False`` is the flat segment-sum.
    """
    _check_axis(mesh, axis)
    n_pad, ssz = layout.padded_nodes, layout.shard_size
    local = (_local_spmv(layout, mesh, _shard_streams(layout, mesh),
                         blocked=blocked)
             if mesh.shard is not None else None)

    def spmv(x: torch.Tensor) -> torch.Tensor:
        squeeze = x.dim() == 1
        xs = x[:, None] if squeeze else x
        if local is not None:
            lo = mesh.shard * ssz
            y = _gather_rows(mesh, local(xs[lo:lo + ssz]), n_pad)
        else:
            y = _gather_rows(mesh, xs.new_empty((ssz,) + xs.shape[1:]),
                             n_pad)
        return y[:, 0] if squeeze else y

    return spmv


def edge_cut_spmv(g: Graph, num_shards: int, mesh: ShardMesh,
                  axis: Optional[str] = None):
    """Distributed BVGAS baseline: one update PER cross-shard edge on
    the wire (no dedup). Send buffers are per-edge values grouped by
    destination shard. The receiving shard's destination ids are static,
    so every rank reads them from the host layout instead of receiving
    them; the values' all-to-all is the baseline's wire."""
    _check_axis(mesh, axis)
    if mesh.num_shards != num_shards:
        raise ValueError(f"mesh has {mesh.num_shards} shards, not "
                         f"{num_shards}")
    shard_size = -(-g.num_nodes // num_shards)
    n_pad = num_shards * shard_size
    src, dst = g.src.astype(np.int64), g.dst.astype(np.int64)
    s_sh, d_sh = src // shard_size, dst // shard_size
    order = np.lexsort((dst, d_sh, s_sh))
    src_o, dst_o = src[order], dst[order]
    ssh_o, dsh_o = s_sh[order], d_sh[order]
    counts = np.zeros(num_shards * num_shards, dtype=np.int64)
    np.add.at(counts, ssh_o * num_shards + dsh_o, 1)
    e_max = max(int(counts.max(initial=0)), 1)
    send_src = np.full((num_shards, num_shards, e_max), -1, np.int32)
    send_dst = np.full((num_shards, num_shards, e_max), shard_size,
                       np.int32)
    grp = ssh_o * num_shards + dsh_o
    first = np.zeros(len(grp), dtype=np.int64)
    if len(grp):
        starts = np.flatnonzero(np.r_[True, grp[1:] != grp[:-1]])
        sizes = np.diff(np.r_[starts, len(grp)])
        first = np.repeat(np.arange(len(grp))[starts], sizes)
    rank = np.arange(len(grp)) - first
    send_src[ssh_o, dsh_o, rank] = src_o - ssh_o * shard_size
    send_dst[ssh_o, dsh_o, rank] = dst_o - dsh_o * shard_size

    s = mesh.shard
    if s is not None:
        ids = send_src[s].reshape(-1)
        send = torch.from_numpy(np.where(ids < 0, shard_size, ids)).to(
            mesh.device)
        # what shard s receives from each shard r: r's buffer for s
        recv_dst = torch.from_numpy(np.ascontiguousarray(
            send_dst[:, s].reshape(-1))).to(mesh.device)

    def spmv(x: torch.Tensor) -> torch.Tensor:
        squeeze = x.dim() == 1
        xs = x[:, None] if squeeze else x
        d = xs.shape[1]
        if s is None:
            y = _gather_rows(mesh, xs.new_empty(shard_size, d), n_pad)
        else:
            x_l = xs[s * shard_size:(s + 1) * shard_size]
            rows = torch.cat([x_l, x_l.new_zeros(1, d)])
            bufs = rows.index_select(0, send)           # (S*E, d)
            recv = torch.empty_like(bufs)
            mesh.all_to_all(recv, bufs)
            y_l = _segment_sum(recv, recv_dst, shard_size + 1)[:shard_size]
            y = _gather_rows(mesh, y_l, n_pad)
        return y[:, 0] if squeeze else y

    return spmv


# ----------------------------------------------- fused sharded iteration
def _host_float(t: torch.Tensor) -> float:
    """``float(t)``: the sharded loop's one host read per check (a
    module function, so tests can count the reads)."""
    return float(t)


def sharded_power_iteration(layout: ShardedPNG, mesh: ShardMesh,
                            axis: Optional[str] = None, *,
                            damping: float = 0.85,
                            num_iterations: int = 20, tol: float = 0.0,
                            check_every: int = 1, multi: bool = False,
                            dangling: str = "none"):
    """Sharded PageRank loop (DESIGN.md §6).

    Returns ``run(pr0, inv_deg, base) -> (pr, it, residuals)`` over full
    PADDED arrays (``n_pad = S * shard_size``, the same on every rank):
    ``base`` is the already-(1-damping)-scaled teleport vector (zero in
    pad slots), ``residuals`` a (num_iterations,) device tensor with -1
    where convergence was not checked. Each shard iterates its own rows:

    - scatter + all-to-all + shard-local blocked gather per step;
    - the L1 residual is all-reduced on each check, so the ``tol``/
      ``check_every`` early exit is the same decision on every rank (one
      host read per check, none with ``tol == 0``);
    - ``dangling="redistribute"`` all-reduces the rank mass parked on
      zero-out-degree nodes each step and redistributes it over the
      teleport distribution (``base / (1 - damping)``), conserving total
      mass at 1;
    - pad rows are masked to zero each step.

    With ``multi=True`` the state is (n_pad, d), d independent rank
    vectors in lockstep; the residual is the max over columns. The
    result is gathered to every rank once, at the end.
    """
    if dangling not in ("none", "redistribute"):
        raise ValueError(f"unknown dangling policy {dangling!r}")
    _check_axis(mesh, axis)
    n_pad, ssz = layout.padded_nodes, layout.shard_size
    member = mesh.shard is not None
    if member:
        st = _shard_streams(layout, mesh)
        spmv = _local_spmv(layout, mesh, st)

    def iterate(pr, inv_deg, base, residuals) -> tuple[torch.Tensor, int]:
        # this shard's rows, as (shard_size, c) columns
        p = pr[st.lo:st.hi].reshape(ssz, -1)
        b = base[st.lo:st.hi].reshape(ssz, -1)
        inv_col = inv_deg[st.lo:st.hi, None]
        mask_col = st.mask[:, None]
        dang_col = (inv_col == 0).to(p.dtype) * mask_col
        redist = b * (damping / (1.0 - damping))
        it = 0
        while it < num_iterations:
            p_next = spmv(p * inv_col)             # scaled ranks (alg.1 l.3)
            p_next.mul_(damping).add_(b)
            if dangling == "redistribute":
                dmass = mesh.all_reduce((p * dang_col).sum(0))
                p_next.add_(dmass * redist)
            p_next.mul_(mask_col)
            check = ((it + 1) % check_every == 0
                     or it + 1 >= num_iterations)
            if check:
                res = mesh.all_reduce((p_next - p).abs_().sum(0))
                res = res.max() if multi else res[0]
                residuals[it] = res
            p = p_next
            it += 1
            # the only host read inside the loop: one all-reduced scalar
            # per check, and only when an early exit is possible
            if check and tol > 0 and 0.0 <= _host_float(res) < tol:
                break
        return p, it

    def run(pr, inv_deg, base):
        residuals = torch.full((max(num_iterations, 1),), -1.0,
                               dtype=torch.float32, device=pr.device)
        if member:
            p, it = iterate(pr, inv_deg, base, residuals)
            out = pr.new_empty(pr.shape)
            mesh.all_gather(out.view(n_pad, -1), p)
        else:
            out, it = pr.new_empty(pr.shape), 0
        if mesh.group is not None and mesh.world_size > mesh.num_shards:
            # ranks outside the mesh: ranks, count and residuals in one
            # broadcast
            packed = torch.cat([out.reshape(-1).float(),
                                torch.tensor([float(it)], device=pr.device),
                                residuals])
            mesh.share(packed)
            size = out.numel()
            out = packed[:size].view(out.shape).to(out.dtype)
            it = int(packed[size])
            residuals = packed[size + 1:]
        return out, it, residuals

    return run


def sharded_chunk_stepper(layout: ShardedPNG, mesh: ShardMesh,
                          axis: Optional[str] = None, *,
                          damping: float = 0.85, chunk: int = 8,
                          dangling: str = "none"):
    """Sharded counterpart of ``core.pagerank.masked_chunk_stepper``
    (DESIGN.md §7): advances an (n_pad, B) slot pool by up to ``chunk``
    iterations, each rank its own rows — scatter + all-to-all + blocked
    gather per step, per-column L1 residuals all-reduced so each column's
    freeze decision is the same on every rank. Per-column ``tol_col``/
    ``budget`` are (B,) data replicated on every rank; frozen columns
    are masked out of the damping update exactly as in the single-device
    stepper, and a non-finite residual freezes its column (quarantine).

    Returns ``step(pr, base, active, tol_col, budget, inv_deg) ->
    (pr, active, took, res)`` over full PADDED ``pr``/``base``/
    ``inv_deg`` (the same on every rank). ``pr`` is updated in place:
    each rank writes its own rows every iteration, and the rows are
    gathered to every rank once, at the end of the call. Every rank of
    the world must be in the mesh. The loop exits as soon as every
    column froze (one host read of ``active.any()`` per iteration but
    the last, as in the single-device stepper).
    """
    if dangling not in ("none", "redistribute"):
        raise ValueError(f"unknown dangling policy {dangling!r}")
    _check_axis(mesh, axis)
    if mesh.shard is None or mesh.world_size != mesh.num_shards:
        raise ValueError("the sharded chunk stepper needs every rank in "
                         "the mesh (num_shards == world size)")
    st = _shard_streams(layout, mesh)
    spmv = _local_spmv(layout, mesh, st)

    def step(pr, base, active, tol_col, budget, inv_deg):
        p = pr[st.lo:st.hi]                       # a view: written in place
        b = base[st.lo:st.hi]
        inv_col = inv_deg[st.lo:st.hi, None]
        mask_col = st.mask[:, None]
        if dangling == "redistribute":
            dang_col = (inv_col == 0).to(p.dtype) * mask_col
            redist = b * (damping / (1.0 - damping))
        took = torch.zeros(pr.shape[1], dtype=torch.int32, device=pr.device)
        res = torch.full((pr.shape[1],), -1.0, dtype=torch.float32,
                         device=pr.device)
        act = active.clone()
        work = torch.empty_like(p)
        written = False
        try:
            for i in range(chunk):
                torch.mul(p, inv_col, out=work)        # scaled ranks
                p_next = spmv(work)                    # a fresh buffer
                p_next.mul_(damping).add_(b)
                if dangling == "redistribute":
                    dmass = mesh.all_reduce((p * dang_col).sum(0))
                    p_next.add_(dmass[None, :] * redist)
                p_next.mul_(mask_col)
                r = mesh.all_reduce(
                    torch.sub(p_next, p, out=work).abs_().sum(0))
                torch.where(act[None, :], p_next, p, out=p)   # freeze
                written = True
                res = torch.where(act, r, res)
                took += act.to(torch.int32)
                # quarantine: the residual is all-reduced, so every rank
                # freezes a NaN/Inf-poisoned column on the same iteration
                act &= torch.isfinite(r) & (r >= tol_col) & (took < budget)
                if i + 1 < chunk and not pagerank_mod._host_any(act):
                    break
            mesh.all_gather(pr, p.clone())
        except Exception as exc:
            raise pagerank_mod.StepperFailure(
                exc, pool_written=written) from exc
        return pr, act, took, res

    return step


def distributed_pagerank(g: Graph, mesh: ShardMesh,
                         axis: Optional[str] = None, *,
                         num_iterations: int = 20, damping: float = 0.85,
                         tol: float = 0.0, check_every: int = 1,
                         dangling: str = "none",
                         layout: ShardedPNG | None = None,
                         fused_cache: dict | None = None):
    """PageRank over the sharded PCPM engine (DESIGN.md §6), on every
    rank of the world.

    ``fused_cache`` (the plan-level loop cache when called through
    ``pagerank()``/``Session``) memoizes the loop per hyper-parameter
    set, as the single-device driver does.

    Returns a ``PageRankResult`` (ranks sliced back to ``num_nodes``, on
    the mesh's device).
    """
    _check_axis(mesh, axis)
    layout = layout or build_sharded_png(g, mesh.num_shards)
    if layout.num_shards != mesh.num_shards:
        raise ValueError(f"layout has {layout.num_shards} shards, the mesh "
                         f"{mesh.num_shards}")
    key = ("sharded_fused", mesh, damping, num_iterations, tol,
           check_every, dangling)
    run = fused_cache.get(key) if fused_cache is not None else None
    if run is None:
        run = sharded_power_iteration(layout, mesh, damping=damping,
                                      num_iterations=num_iterations,
                                      tol=tol, check_every=check_every,
                                      dangling=dangling)
        if fused_cache is not None:
            fused_cache[key] = run
    n, dev = g.num_nodes, mesh.device
    pr0 = torch.zeros(layout.padded_nodes, dtype=torch.float32, device=dev)
    pr0[:n] = 1.0 / n
    base = torch.zeros_like(pr0)
    base[:n] = (1.0 - damping) / n
    pr, it, res = run(pr0, padded_inv_degree(g, layout, dev), base)
    res_host = res[:it].cpu().numpy()
    return pagerank_mod.PageRankResult(
        pr[:n], it, [float(r) for r in res_host if r >= 0.0])
