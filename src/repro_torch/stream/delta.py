"""Streaming edge deltas (a copy of the JAX package's ``stream/delta.py``;
DESIGN.md §9).

A production graph gains and loses edges continuously; rebuilding the
whole ``GraphPlan`` and re-running full power iteration per batch would
throw away the paper's preprocess-once amortization exactly where it
matters most.  This module owns the *data model* of change:

- ``GraphDelta``: one batch of edge insertions and removals (COO
  arrays, multiset semantics — removing one copy of a multi-edge
  removes exactly one).  Immutable and composable.
- ``apply_delta``: pure edge-list update ``(Graph, delta) -> Graph``
  with loud failure on removing a non-existent edge.
- ``DynamicGraph``: a mutable handle over a stream of deltas.  It
  tracks which *destination partitions* the accumulated deltas touch —
  the unit of incremental plan patching (stream/patch.py): partitions
  are contiguous destination-ID ranges, every per-partition layout
  segment (PNG bins, gather runs, blocked rows) depends only on the
  edges landing in that partition, so a delta dirties exactly
  ``{dst // part_size}`` of its edges.  It also tracks the *touched
  sources* — the support of the residual seed (stream/incremental.py):
  the PageRank operator column of node u changes iff u's out-edge set
  changed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.plan import _edge_hash64, _fp_string
from ..graphs.formats import Graph


_EMPTY = np.empty(0, dtype=np.int32)


def _as_edges(edges) -> tuple[np.ndarray, np.ndarray]:
    e = np.asarray(edges)
    if e.size == 0:
        return _EMPTY, _EMPTY
    if e.dtype.kind not in "iu":
        raise ValueError(
            f"delta edges must be integer-typed; got dtype {e.dtype} "
            "(converting floats would silently truncate node ids)")
    if e.ndim != 2 or e.shape[1] != 2:
        raise ValueError(f"edges must be (m, 2) (src, dst) pairs; "
                         f"got shape {e.shape}")
    e = e.astype(np.int32, copy=False)
    return (np.ascontiguousarray(e[:, 0]), np.ascontiguousarray(e[:, 1]))


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One batch of edge changes: ``add_*`` are inserted, ``rem_*``
    removed (one multi-edge copy per entry). The defaults are factories:
    a dataclass refuses an array as a plain default."""
    add_src: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY)
    add_dst: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY)
    rem_src: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY)
    rem_dst: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY)

    # ------------------------------------------------------ constructors
    @staticmethod
    def insert(edges) -> "GraphDelta":
        src, dst = _as_edges(edges)
        return GraphDelta(add_src=src, add_dst=dst)

    @staticmethod
    def remove(edges) -> "GraphDelta":
        src, dst = _as_edges(edges)
        return GraphDelta(rem_src=src, rem_dst=dst)

    @staticmethod
    def of(add=None, remove=None) -> "GraphDelta":
        a_src, a_dst = _as_edges(add if add is not None else [])
        r_src, r_dst = _as_edges(remove if remove is not None else [])
        return GraphDelta(a_src, a_dst, r_src, r_dst)

    # ------------------------------------------------------------- views
    @property
    def num_added(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def num_removed(self) -> int:
        return int(self.rem_src.shape[0])

    @property
    def size(self) -> int:
        return self.num_added + self.num_removed

    @property
    def is_empty(self) -> bool:
        return self.size == 0

    def __add__(self, other: "GraphDelta") -> "GraphDelta":
        """Concatenate two batches.  The result describes the combined
        edge-multiset change relative to the ORIGINAL graph; the
        residual-seed algebra (stream/incremental.py) treats an
        insertion later removed as a term-for-term no-op, so no
        cancellation is needed there.  (Do not feed a concatenated
        batch back through ``apply_delta`` — its removals are matched
        against the base graph, which may not yet contain the first
        batch's insertions.)"""
        return GraphDelta(
            np.concatenate([self.add_src, other.add_src]),
            np.concatenate([self.add_dst, other.add_dst]),
            np.concatenate([self.rem_src, other.rem_src]),
            np.concatenate([self.rem_dst, other.rem_dst]))

    def touched_sources(self) -> np.ndarray:
        """Unique source ids whose out-edge set this delta changes —
        the support of the residual seed (their operator columns are
        the only ones that differ)."""
        return np.unique(np.concatenate([self.add_src, self.rem_src]))

    def dirty_partitions(self, part_size: int) -> np.ndarray:
        """Sorted unique destination partitions this delta touches —
        the only partitions whose plan segments need rebuilding."""
        dst = np.concatenate([self.add_dst, self.rem_dst])
        return np.unique(dst.astype(np.int64) // part_size)

    def validate(self, g: Graph) -> None:
        """Bounds-check endpoints against ``g`` (removal existence is
        checked edge-by-edge inside ``apply_delta``)."""
        for name, arr in (("add_src", self.add_src),
                          ("add_dst", self.add_dst),
                          ("rem_src", self.rem_src),
                          ("rem_dst", self.rem_dst)):
            if arr.size and (arr.min() < 0 or arr.max() >= g.num_nodes):
                raise ValueError(
                    f"delta {name} ids out of range [0, {g.num_nodes})")


def multiset_keep_mask(src: np.ndarray, dst: np.ndarray,
                       rem_src: np.ndarray, rem_dst: np.ndarray, *,
                       num_nodes: int) -> np.ndarray:
    """Boolean keep-mask over the ``(src, dst)`` edge arrays with one
    edge dropped per removal entry (multiset semantics).  Raises on a
    removal that has no remaining match.  Shared by whole-graph
    ``apply_delta`` and the per-dirty-partition patcher."""
    n = np.int64(num_nodes)
    # only edges whose destination some removal names can match one:
    # the JAX package sorts the keys of all M edges; sorting just these
    # candidates (kept in edge order, so the stable sort picks the same
    # copies) gives the same mask in O(M + candidates log candidates)
    cand = np.flatnonzero(np.isin(dst, np.unique(rem_dst)))
    keys = src[cand].astype(np.int64) * n + dst[cand]
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    rem_keys, rem_counts = np.unique(
        rem_src.astype(np.int64) * n + rem_dst, return_counts=True)
    lo = np.searchsorted(sorted_keys, rem_keys, side="left")
    hi = np.searchsorted(sorted_keys, rem_keys, side="right")
    short = rem_counts > hi - lo
    if short.any():
        i = int(np.flatnonzero(short)[0])
        u, v = divmod(int(rem_keys[i]), int(n))
        raise ValueError(
            f"cannot remove edge ({u}, {v}) x{int(rem_counts[i])}: "
            f"only {int(hi[i] - lo[i])} present")
    # flat positions (in sorted order) of the removed copies: the first
    # ``count`` occurrences of each key
    flat = (np.repeat(lo, rem_counts)
            + _intra_group_arange(rem_counts))
    keep = np.ones(len(src), dtype=bool)
    keep[cand[order[flat]]] = False
    return keep


def _intra_group_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... as one flat array."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(total, dtype=np.int64) - starts


def gather_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flat indices [s0..s0+c0) ++ [s1..s1+c1) ++ ... — the vectorized
    slice-concatenation used throughout the patcher."""
    counts = np.asarray(counts, dtype=np.int64)
    return np.repeat(np.asarray(starts, dtype=np.int64),
                     counts) + _intra_group_arange(counts)


def apply_delta(g: Graph, delta: GraphDelta) -> Graph:
    """Pure edge-list update.  The result's edge order is kept
    partition-stable (survivors first, insertions appended) but plans
    never depend on it — every backend sorts, and the content
    fingerprint hashes the edge multiset.

    If ``g``'s plan fingerprint is already memoized, the new graph's
    is derived incrementally (the multiset hash is a commutative-
    invertible sum/xor pair — O(|delta|), core/plan.py) so a delta
    stream never re-hashes the full edge list."""
    delta.validate(g)
    if delta.num_removed:
        keep = multiset_keep_mask(g.src, g.dst, delta.rem_src,
                                  delta.rem_dst, num_nodes=g.num_nodes)
        src, dst = g.src[keep], g.dst[keep]
    else:
        src, dst = g.src, g.dst
    if delta.num_added:
        src = np.concatenate([src, delta.add_src])
        dst = np.concatenate([dst, delta.add_dst])
    g_new = Graph(g.num_nodes, np.ascontiguousarray(src),
                  np.ascontiguousarray(dst))
    parts = g.__dict__.get("_fp_parts")
    if parts is not None:
        u64 = np.uint64
        h_add = _edge_hash64(delta.add_src, delta.add_dst)
        h_rem = _edge_hash64(delta.rem_src, delta.rem_dst)
        s = (parts[0] + int(h_add.sum(dtype=u64))
             - int(h_rem.sum(dtype=u64))) % (1 << 64)
        x = (parts[1]
             ^ int(np.bitwise_xor.reduce(h_add, initial=u64(0)))
             ^ int(np.bitwise_xor.reduce(h_rem, initial=u64(0))))
        g_new.__dict__["_fp_parts"] = (s, x)
    return g_new


def shifted_fingerprint(fp: str, delta: GraphDelta) -> str:
    """The content fingerprint of ``g + delta`` derived from ``g``'s
    fingerprint alone — O(|delta|), via the commutative sum/xor hash
    (core/plan.py).  ``patch_plan`` uses it to REQUIRE that a
    caller-supplied ``g_new`` really equals ``g_old + delta`` before
    stamping spliced arrays with ``g_new``'s fingerprint."""
    n_hex, m_hex, digest = fp.split(".")
    h_add = _edge_hash64(delta.add_src, delta.add_dst)
    h_rem = _edge_hash64(delta.rem_src, delta.rem_dst)
    u64 = np.uint64
    s = (int(digest[:16], 16) + int(h_add.sum(dtype=u64))
         - int(h_rem.sum(dtype=u64))) % (1 << 64)
    x = (int(digest[16:], 16)
         ^ int(np.bitwise_xor.reduce(h_add, initial=u64(0)))
         ^ int(np.bitwise_xor.reduce(h_rem, initial=u64(0))))
    m_new = int(m_hex, 16) + delta.num_added - delta.num_removed
    return _fp_string(int(n_hex, 16), m_new, (s, x))


class DynamicGraph:
    """Mutable handle over a stream of deltas.

    ``apply`` advances the current graph; the handle accumulates which
    partitions are dirty and which sources are touched SINCE THE LAST
    ``mark_clean()`` — the consumer (Session warm state, patch
    batching) decides when accumulated changes have been folded into a
    plan / rank vector and resets the dirty sets.
    """

    def __init__(self, g: Graph):
        self.graph = g
        self.version = 0
        self._base_graph = g
        self._touched: list[np.ndarray] = []
        self._dirty_dst: list[np.ndarray] = []

    @property
    def base_graph(self) -> Graph:
        """The graph as of the last ``mark_clean`` (construction if
        never cleaned) — what accumulated dirtiness is relative to."""
        return self._base_graph

    def apply(self, delta: GraphDelta) -> Graph:
        self.graph = apply_delta(self.graph, delta)
        self.version += 1
        self._touched.append(np.concatenate([delta.add_src,
                                             delta.rem_src]))
        self._dirty_dst.append(np.concatenate([delta.add_dst,
                                               delta.rem_dst]))
        return self.graph

    def touched_sources(self) -> np.ndarray:
        return np.unique(np.concatenate(self._touched or [_EMPTY]))

    def dirty_partitions(self, part_size: int) -> np.ndarray:
        dst = np.concatenate(self._dirty_dst or [_EMPTY])
        return np.unique(dst.astype(np.int64) // part_size)

    def dirty_fraction(self, part_size: int, num_partitions: int) -> float:
        return len(self.dirty_partitions(part_size)) / max(
            num_partitions, 1)

    def mark_clean(self) -> None:
        """Accumulated changes have been folded (plan patched, ranks
        updated) — restart dirtiness tracking from the current graph."""
        self._base_graph = self.graph
        self._touched.clear()
        self._dirty_dst.clear()
