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


def _packed_keys(cols, spare: int = 0
                 ) -> tuple[np.ndarray, list[int]] | None:
    """``cols`` (primary first) packed into one int64 key per row, each
    column in the bits its largest value needs, ``spare`` low bits left
    free; None when a column holds a negative value or the bits exceed
    63."""
    bits = []
    for col in cols:
        if len(col) and int(col.min()) < 0:
            return None
        bits.append(int(col.max(initial=0)).bit_length())
    if sum(bits) + spare > 63:
        return None
    key = np.zeros(len(cols[0]), dtype=np.int64)
    for col, nb in zip(cols, bits):
        key <<= nb
        key |= col.astype(np.int64, copy=False)
    return key, bits


def lexsort_order(*cols: np.ndarray) -> np.ndarray:
    """The permutation ``np.lexsort(cols[::-1])`` gives (rows by
    ``cols[0]``, then ``cols[1]``, ..., equal rows in input order). Where
    the rows and their positions fit in 63 bits, each row is packed into
    an int64 key with its position in the low bits: the keys are
    distinct, so one unstable sort of the keys themselves gives the
    order (``tools/host_sort_ab.py`` times it against ``np.lexsort`` and
    a stable argsort of the packed rows); else ``np.lexsort``."""
    pos_bits = max(len(cols[0]) - 1, 0).bit_length()
    packed = _packed_keys(cols, pos_bits)
    if packed is None:
        return np.lexsort(cols[::-1])
    key, _ = packed
    key <<= pos_bits
    key |= np.arange(len(key), dtype=np.int64)
    key.sort()
    return key & ((1 << pos_bits) - 1)


def lexsorted(*cols: np.ndarray) -> tuple[np.ndarray, ...]:
    """The columns gathered in ``lexsort_order(*cols)``, each in its own
    dtype, for callers that need only the sorted values: the packed keys
    are sorted themselves (the order of equal rows cannot show), then
    unpacked. At 65M edges this is one sort of the keys in place of
    ``np.lexsort``'s three stable passes and three gathers."""
    packed = _packed_keys(cols)
    if packed is None:
        order = np.lexsort(cols[::-1])
        return tuple(col[order] for col in cols)
    key, bits = packed
    key.sort()
    out, shift = [], sum(bits)
    for col, nb in zip(cols, bits):
        shift -= nb
        out.append(((key >> shift) & ((1 << nb) - 1)).astype(col.dtype))
    return tuple(out)


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
        """(offsets[n+1], indices[m]) with edges sorted by src then dst:
        the indices the JAX package's ``lexsort`` gives, an order of
        magnitude sooner (``lexsorted``; a streamed graph builds it once
        per version: the warm update's residual seed reads it)."""
        offsets = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.add.at(offsets, self.src + 1, 1)
        np.cumsum(offsets, out=offsets)
        return offsets, lexsorted(self.src, self.dst)[1].astype(np.int32)

    @cached_property
    def csc(self) -> tuple[np.ndarray, np.ndarray]:
        """(offsets[n+1], indices[m]) with edges sorted by dst then src."""
        offsets = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.add.at(offsets, self.dst + 1, 1)
        np.cumsum(offsets, out=offsets)
        return offsets, lexsorted(self.dst, self.src)[1].astype(np.int32)

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
