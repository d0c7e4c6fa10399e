"""Graph containers.

Host-side (numpy) representations used for pre-processing — CSR build,
partitioning, PNG construction — plus a device (torch) view for
compute. The paper assumes CSR is given (§VI-D3); we build it once at
load time.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed graph in COO form with lazily-built CSR/CSC views.

    ``src``/``dst`` are int32 numpy arrays of equal length (one entry per
    edge). Self-loops and multi-edges are permitted (multi-edges matter:
    PNG compression dedups (src, dst-partition) pairs, and the achieved
    compression ratio r is reported against the raw edge count, as the
    paper does).
    """

    num_nodes: int
    src: np.ndarray
    dst: np.ndarray

    def __post_init__(self):
        for name, arr in (("src", self.src), ("dst", self.dst)):
            if not isinstance(arr, np.ndarray) or arr.dtype != np.int32:
                raise ValueError(
                    f"Graph.{name} must be an int32 numpy array; got "
                    f"{getattr(arr, 'dtype', type(arr).__name__)} "
                    "(float/int64 edge arrays must be converted "
                    "explicitly — silent truncation hides bad ids)")
            if arr.ndim != 1:
                raise ValueError(f"Graph.{name} must be 1-D (one entry "
                                 f"per edge); got shape {arr.shape}")
        if self.src.shape != self.dst.shape:
            raise ValueError(
                f"Graph src/dst must have equal length; got "
                f"{self.src.shape[0]} vs {self.dst.shape[0]}")
        if int(self.num_nodes) < 1:
            raise ValueError(
                f"Graph needs num_nodes >= 1; got {self.num_nodes}")

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    # ---------------------------------------------------------------- CSR
    @cached_property
    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(offsets[n+1], indices[m]) with edges sorted by src then dst.
        One sort of the int64 keys ``src·n + dst`` gives the indices the
        JAX package's ``lexsort`` gives, an order of magnitude sooner (a
        streamed graph builds it once per version: the warm update's
        residual seed reads it)."""
        offsets = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.add.at(offsets, self.src + 1, 1)
        np.cumsum(offsets, out=offsets)
        n = np.int64(self.num_nodes)
        keys = self.src.astype(np.int64) * n + self.dst
        keys.sort()
        return offsets, (keys % n).astype(np.int32)

    @cached_property
    def csc(self) -> tuple[np.ndarray, np.ndarray]:
        """(offsets[n+1], indices[m]) with edges sorted by dst then src."""
        order = np.lexsort((self.src, self.dst))
        offsets = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.add.at(offsets, self.dst + 1, 1)
        np.cumsum(offsets, out=offsets)
        return offsets, self.src[order].astype(np.int32)

    @cached_property
    def out_degree(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, dtype=np.int64)
        np.add.at(deg, self.src, 1)
        return deg

    @cached_property
    def in_degree(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, dtype=np.int64)
        np.add.at(deg, self.dst, 1)
        return deg

    # ------------------------------------------------------------- device
    def device_coo(self, device: str | torch.device | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(src, dst)`` as int32 tensors on ``device`` (default cuda)."""
        from ..device import resolve_device
        dev = resolve_device(device)
        return (torch.from_numpy(self.src).to(dev),
                torch.from_numpy(self.dst).to(dev))

    def relabel(self, perm: np.ndarray) -> "Graph":
        """Apply a node relabeling: new_id = perm[old_id]."""
        perm = perm.astype(np.int32)
        return Graph(self.num_nodes, perm[self.src], perm[self.dst])

    def reverse(self) -> "Graph":
        return Graph(self.num_nodes, self.dst, self.src)


def validate_graph(g: Graph) -> Graph:
    """Front-door id-range check: every edge endpoint must lie in
    ``[0, num_nodes)``. Out-of-range ids otherwise surface as obscure
    index errors deep inside partitioning — O(m) on first call, memoized
    on the instance so every front door can call it for free
    afterwards."""
    if g.__dict__.get("_validated"):
        return g
    for name, arr in (("src", g.src), ("dst", g.dst)):
        if arr.size:
            lo, hi = int(arr.min()), int(arr.max())
            if lo < 0 or hi >= g.num_nodes:
                raise ValueError(
                    f"graph {name} ids span [{lo}, {hi}], outside "
                    f"[0, {g.num_nodes}) — negative or out-of-range "
                    "node ids")
    g.__dict__["_validated"] = True   # frozen-safe: dict write
    return g


def from_edge_list(num_nodes: int, edges: np.ndarray) -> Graph:
    """edges: (m, 2) array of (src, dst)."""
    e = np.asarray(edges)
    if e.size and e.dtype.kind not in "iu":
        raise ValueError(
            f"edge list must be integer-typed; got dtype {e.dtype} "
            "(converting floats would silently truncate node ids)")
    e = e.astype(np.int32, copy=False)
    if e.ndim != 2 or e.shape[1] != 2:
        raise ValueError(f"edges must be (m, 2) (src, dst) pairs; got "
                         f"shape {e.shape}")
    return Graph(num_nodes, np.ascontiguousarray(e[:, 0]),
                 np.ascontiguousarray(e[:, 1]))
