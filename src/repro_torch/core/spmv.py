"""The three SpMV engines from the paper, as torch ops.

All compute  y = A^T @ x  for the (possibly multi-)vector x — PageRank
uses x = scaled ranks, GNNs use x = node features (n, d).

- ``pdpr``  : pull-direction baseline (alg. 1) — per-destination gather
              of source values, i.e. segment-sum over CSC order.
- ``bvgas`` : Binning w/ Vertex-centric GAS (alg. 2) — scatter phase
              materializes one update PER EDGE into dst-partition-major
              bins; gather phase segment-sums them.
- ``pcpm``  : Partition-Centric (algs. 4+5) — scatter phase materializes
              one update PER (src, dst-partition) pair (the PNG update
              stream, m/r entries); gather expands updates over edges via
              the ``edge_update_idx`` stream and segment-sums.

The JAX package's ``jax.ops.segment_sum`` becomes ``index_add_`` into a
zeroed buffer and its gathers ``index_select``; both take the int32
index streams as they are, so no stream is widened to int64. PyTorch
runs eagerly, so the scatter's bins always materialize in device memory
between the two phases — the paper's bins round trip.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_device_tensor, resolve_device
from ..graphs.formats import Graph, lexsorted
from .partition import Partitioning
from .png import PNGLayout, build_gather_schedule, build_png


# ---------------------------------------------------------------------------
# Device-resident layouts
# ---------------------------------------------------------------------------
def _upload(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


@dataclasses.dataclass(frozen=True)
class DeviceCSC:
    """Edges sorted by destination (pull order)."""
    num_nodes: int
    src: torch.Tensor   # (m,) int32, sorted by dst
    dst: torch.Tensor   # (m,) int32, ascending

    @staticmethod
    def build(g: Graph, *, device=None) -> "DeviceCSC":
        dev = resolve_device(device)
        dst, src = lexsorted(g.dst, g.src)
        return DeviceCSC(g.num_nodes, _upload(src, dev), _upload(dst, dev))


@dataclasses.dataclass(frozen=True)
class DeviceBVGAS:
    """Edges sorted by destination partition (BVGAS deterministic layout:
    dst ids are written once, then reused every iteration)."""
    num_nodes: int
    src: torch.Tensor   # (m,) int32, dst-partition-major
    dst: torch.Tensor   # (m,) int32

    @staticmethod
    def build(g: Graph, part: Partitioning, *,
              device=None) -> "DeviceBVGAS":
        dev = resolve_device(device)
        dstp = g.dst.astype(np.int64) // part.part_size
        _, src, dst = lexsorted(dstp, g.src, g.dst)
        return DeviceBVGAS(g.num_nodes, _upload(src, dev), _upload(dst, dev))


@dataclasses.dataclass(frozen=True)
class DevicePNG:
    """Flat PNG streams on a device (see core/png.py), plus the blocked
    gather schedule (piece bounds over the dst-sorted edge stream)."""
    num_nodes: int
    update_src: torch.Tensor       # (U,) int32
    edge_update_idx: torch.Tensor  # (M,) int32
    edge_dst: torch.Tensor         # (M,) int32, ascending
    compression_ratio: float
    # blocked-gather schedule (see png.build_gather_schedule)
    gather_block: int
    eui_padded: torch.Tensor       # (Mp,) int32
    piece_start: torch.Tensor      # (P0,) int32
    piece_end: torch.Tensor        # (P0,) int32
    piece_dst: torch.Tensor        # (P0,) int32, pad = num_nodes

    @staticmethod
    def build(g: Graph, part: Partitioning,
              layout: PNGLayout | None = None, *,
              gather_block: int = 256, device=None) -> "DevicePNG":
        dev = resolve_device(device)
        layout = layout or build_png(g, part)
        sched = build_gather_schedule(layout, block=gather_block)
        return DevicePNG(layout.num_nodes,
                         _upload(layout.update_src, dev),
                         _upload(layout.edge_update_idx, dev),
                         _upload(layout.edge_dst, dev),
                         layout.compression_ratio, sched.block,
                         *(_upload(a, dev) for a in (
                             sched.edge_update_idx_padded,
                             sched.piece_start, sched.piece_end,
                             sched.piece_dst)))


def _segment_sum(vals: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: out[s] = Σ vals[i] over segment_ids[i]
    == s, for (m,) or (m, d) ``vals``."""
    out = vals.new_zeros((num_segments,) + tuple(vals.shape[1:]))
    return out.index_add_(0, segment_ids, vals)


def pdpr_spmv(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
              *, num_nodes: int) -> torch.Tensor:
    """Pull-direction SpMV: y[v] = sum_{(u,v) in E} x[u]."""
    return _segment_sum(x.index_select(0, src), dst, num_nodes)


def bvgas_scatter(src: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Scatter: one update per edge, written to dst-partition-major bins."""
    return x.index_select(0, src)


def bvgas_gather(bins: torch.Tensor, dst: torch.Tensor,
                 *, num_nodes: int) -> torch.Tensor:
    return _segment_sum(bins, dst, num_nodes)


def pcpm_scatter(update_src: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Scatter: ONE update per (src, dst-partition) — the PNG compression.
    Update bins are m/r entries instead of m."""
    return x.index_select(0, update_src)


def pcpm_gather(update_bins: torch.Tensor, edge_update_idx: torch.Tensor,
                edge_dst: torch.Tensor, *, num_nodes: int) -> torch.Tensor:
    """Gather: expand each update over its in-partition destinations
    (branch-free analogue of the MSB stream) and accumulate.

    Flat element-wise scatter-add — the shape-agnostic form; the hot
    path is ``pcpm_gather_blocked``.
    """
    return _segment_sum(update_bins.index_select(0, edge_update_idx),
                        edge_dst, num_nodes)


def pcpm_gather_blocked(update_bins: torch.Tensor, eui_padded: torch.Tensor,
                        piece_start: torch.Tensor, piece_end: torch.Tensor,
                        piece_dst: torch.Tensor, *, num_nodes: int,
                        block: int) -> torch.Tensor:
    """Hierarchical gather over the dst-sorted stream.

    Per-block inclusive prefix sums turn each destination's run into a
    difference of two gathers; only the ~n + M/block run sums go through
    the element-wise scatter-add. Identical to ``pcpm_gather`` up to f32
    rounding.
    """
    vals = update_bins.index_select(0, eui_padded)       # (Mp,) or (Mp, d)
    nb = eui_padded.shape[0] // block
    local = vals.view((nb, block) + tuple(vals.shape[1:])).cumsum(1)
    local = local.view(vals.shape)
    lead = local.index_select(0, piece_end)
    prev = local.index_select(0, (piece_start - 1).clamp_(min=0))
    at_block_start = piece_start % block == 0
    if vals.dim() > 1:
        at_block_start = at_block_start[:, None]
    piece_sum = lead - prev.masked_fill_(at_block_start, 0)
    return _segment_sum(piece_sum, piece_dst, num_nodes + 1)[:num_nodes]


def pcpm_spmv(png_update_src: torch.Tensor,
              png_edge_update_idx: torch.Tensor,
              png_edge_dst: torch.Tensor, x: torch.Tensor,
              *, num_nodes: int) -> torch.Tensor:
    """Two-phase PCPM SpMV over the flat PNG streams. The m/r-entry
    update bins materialize in device memory between the phases (the
    JAX package's ``fused=False``; eager torch has no fused form)."""
    bins = pcpm_scatter(png_update_src, x)
    return pcpm_gather(bins, png_edge_update_idx, png_edge_dst,
                       num_nodes=num_nodes)


# Weighted variant (paper §VII extension: weights travel with dest IDs).
def pcpm_spmv_weighted(png_update_src: torch.Tensor,
                       png_edge_update_idx: torch.Tensor,
                       png_edge_dst: torch.Tensor, edge_weight: torch.Tensor,
                       x: torch.Tensor, *, num_nodes: int) -> torch.Tensor:
    vals = x.index_select(0, png_update_src).index_select(
        0, png_edge_update_idx)
    if x.dim() > 1:
        vals = vals * edge_weight[:, None]
    else:
        vals = vals * edge_weight
    return _segment_sum(vals, png_edge_dst, num_nodes)


# ---------------------------------------------------------------------------
# Engine wrapper with a uniform API
# ---------------------------------------------------------------------------
class SpMVEngine:
    """y = A^T x with a fixed graph, on one device — a thin shim over the
    plan/run split: construction resolves ``method`` through the backend
    registry (``core.backends``) and fetches the preprocessing artifact
    from the process-level plan cache (``core.plan``), so two engines on
    the same ``(graph, config)`` share ONE ``GraphPlan``.

    ``method`` is any registered backend: the three paper engines
    (pdpr, bvgas, pcpm), the gather-kernel PCPM path (pcpm_pallas) and
    the all-to-all PCPM path over ranks (pcpm_sharded; vertex-sharded
    over ``num_shards`` ranks, default the world size — see
    core/distributed.py). A prebuilt ``plan`` overrides the knob
    arguments. ``device`` defaults to ``"cuda"`` and raises without CUDA
    (``device.py``). New code should prefer ``repro_torch.open``
    (repro_torch/api.py).
    """

    def __init__(self, g: Graph, *, method: str = "pcpm",
                 part_size: int = 65536, two_phase: bool = False,
                 num_shards: int | None = None, plan=None, device=None):
        from . import backends
        from .plan import PlanConfig, build_plan, validate_plan
        self.device = resolve_device(device)
        if plan is None:
            plan = build_plan(g, PlanConfig(method=method,
                                            part_size=part_size,
                                            num_shards=num_shards))
        else:
            validate_plan(g, plan)
            if plan.sharded is not None:
                backends.check_device_count(plan.sharded.num_shards)
        self.plan = plan
        self.method = plan.method
        self.backend = backends.get_backend(plan.method)
        if two_phase and not self.backend.supports_two_phase:
            raise ValueError(
                f"two_phase=True is only meaningful for the two-phase "
                f"engines; backend {self.method!r} does not support it")
        self.num_nodes = plan.num_nodes
        self.num_edges = plan.num_edges
        self.two_phase = two_phase
        self.partitioning = plan.partitioning
        # mesh axis name — the plan's (normalized) axis, so the drivers,
        # the serving paths and the spmv closure share ONE mesh
        self.shard_axis = plan.config.shard_axis

    # ------------------------------------------------------ plan views
    @property
    def layout(self) -> PNGLayout:
        """The PNG layout (pcpm/pcpm_pallas plans)."""
        if self.plan.png is None:
            raise AttributeError(
                f"backend {self.method!r} has no PNG layout")
        return self.plan.png

    @property
    def sharded_layout(self):
        if self.plan.sharded is None:
            raise AttributeError(
                f"backend {self.method!r} has no sharded layout")
        return self.plan.sharded

    @property
    def mesh(self):
        """The plan's ``ShardMesh`` on this engine's device."""
        from . import backends
        return backends.sharded_mesh(self.plan, self.shard_axis,
                                     self.device)

    @property
    def compression_ratio(self) -> float:
        return self.plan.compression_ratio

    @property
    def _fused_cache(self) -> dict:
        # plan-level, so every engine/driver on one plan shares loops
        from . import backends
        return backends.fused_loop_cache(self.plan)

    def spmv_fn(self):
        """The ``x -> A^T x`` closure over the plan's device-resident
        streams — what the fused PageRank driver consumes. Raises for
        ``two_phase`` engines: the fused driver has no phase barrier.

        For reordered plans (``plan.reorder_perm`` set) this closure
        operates in INTERNAL (relabeled) space — the fused driver
        iterates there and maps results once at the boundary;
        ``__call__`` is the original-space per-pass wrapper."""
        if self.two_phase:
            raise ValueError(
                "a two_phase engine cannot provide a fused spmv_fn: the "
                "fused driver has no host-side phase barrier. Construct "
                "the engine with two_phase=False for fused consumers.")
        from . import backends
        return backends.spmv_fn(self.plan, self.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from . import backends
        fn = (backends.two_phase_spmv_fn(self.plan, self.device)
              if self.two_phase
              else backends.spmv_fn(self.plan, self.device))
        x = as_device_tensor(x, self.device)
        if self.plan.reorder_perm is None:
            return fn(x)
        # reordered plan: the layouts index the relabeled graph, so map
        # x into internal space and the result back — callers see the
        # original labeling
        perm, inv = backends.reorder_device(self.plan, self.device)
        return fn(x.index_select(0, inv)).index_select(0, perm)
