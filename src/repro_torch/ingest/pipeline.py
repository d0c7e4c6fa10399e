"""Composable ingest pipeline: chunks -> filters -> id map -> Graph (a
port of the JAX package's ``ingest/pipeline.py``; the graph it makes is
the one that package makes, array for array).

Stage order per chunk (everything here runs in EXTERNAL id space, so
string-labeled graphs work identically):

1. link filters (:class:`LinkFilter`) — predicate keep masks; dropped
   edges are counted and, per filter, optionally routed to
   :class:`VirtualLinks` instead of vanishing;
2. self-loop policy (``keep`` / ``drop`` / ``virtual``);
3. ``NodeIdMapping.map_chunk`` — AFTER filtering, so nodes reachable
   only through removed links never claim a dense id and the node
   space stays compact;
4. accumulate; optional exact dedup at the end (packed-int64 unique).

Filtered edges are not just discarded: the web-graph practice (Agyar,
SNIPPETS.md) is to solve PageRank on the kept subgraph, then report
how much rank mass WOULD have flowed down the removed links —
:meth:`VirtualLinks.interpret` computes exactly that.
"""
from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..graphs.formats import Graph
from .idmap import NodeIdMapping
from .parse import DEFAULT_CHUNK_EDGES, DEFAULT_COMMENTS, iter_edge_chunks

SELF_LOOP_POLICIES = ("keep", "drop", "virtual")
SELF_LOOP_CATEGORY = "self_loops"


@dataclasses.dataclass(frozen=True)
class LinkFilter:
    """Predicate over external ``(src, dst)`` chunk arrays.

    ``keep(src, dst)`` returns a boolean mask (True = keep the edge).
    Dropped edges are counted under ``name``; with ``virtual=True``
    (default) they are also retained as virtual links so their rank
    mass can be reported after the solve.
    """

    name: str
    keep: Callable[[np.ndarray, np.ndarray], np.ndarray]
    virtual: bool = True

    def __call__(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        mask = np.asarray(self.keep(src, dst), dtype=bool)
        if mask.shape != src.shape:
            raise ValueError(
                f"filter {self.name!r} returned mask of shape "
                f"{mask.shape} for {src.shape[0]} edges")
        return mask


class VirtualLinks:
    """Edges removed during ingest, bucketed by filter name, kept in
    EXTERNAL id space (their endpoints may not exist in the graph)."""

    def __init__(self):
        self._chunks: Dict[str, list] = {}

    def add(self, category: str, src: np.ndarray, dst: np.ndarray):
        if src.size:
            self._chunks.setdefault(category, []).append((src, dst))

    @property
    def categories(self) -> tuple:
        return tuple(self._chunks)

    @property
    def counts(self) -> Dict[str, int]:
        return {c: sum(s.size for s, _ in ch)
                for c, ch in self._chunks.items()}

    def edges(self, category: str) -> tuple:
        ch = self._chunks.get(category, [])
        if not ch:
            e = np.array([], dtype=np.int64)
            return e, e.copy()
        return (np.concatenate([s for s, _ in ch]),
                np.concatenate([d for _, d in ch]))

    def interpret(self, ranks, idmap: NodeIdMapping, graph: Graph,
                  damping: float = 0.85) -> Dict[str, float]:
        """Per-category PageRank mass the removed links would carry.

        After solving on the kept subgraph, node ``u`` would have
        distributed ``damping * pr[u] / (deg_kept(u) + deg_virt(u))``
        along EACH of its links had the virtual ones stayed; summing
        that share over a category's edges estimates the mass flowing
        out of the graph through it.  Virtual edges whose source never
        made it into the graph contribute nothing (their rank is
        unknown).
        """
        ranks = np.asarray(ranks, dtype=np.float64)
        if ranks.shape[0] != graph.num_nodes:
            raise ValueError(
                f"ranks has {ranks.shape[0]} entries for a graph of "
                f"{graph.num_nodes} nodes")
        # total virtual out-degree per in-graph source, all categories
        virt_deg = np.zeros(graph.num_nodes, dtype=np.int64)
        mapped = {}
        for cat in self._chunks:
            src, _ = self.edges(cat)
            s_int = idmap.to_internal(src, missing="mark")
            mapped[cat] = s_int
            known = s_int[s_int >= 0]
            np.add.at(virt_deg, known, 1)
        kept_deg = np.zeros(graph.num_nodes, dtype=np.int64)
        np.add.at(kept_deg, graph.src, 1)
        total_deg = kept_deg + virt_deg
        out = {}
        for cat, s_int in mapped.items():
            known = s_int[s_int >= 0]
            out[cat] = float(
                damping * np.sum(ranks[known] / total_deg[known]))
        return out


@dataclasses.dataclass
class IngestStats:
    edges_read: int = 0
    edges_kept: int = 0
    self_loops_removed: int = 0
    duplicates_removed: int = 0
    filtered: Dict[str, int] = field(default_factory=dict)
    num_nodes: int = 0

    def summary(self) -> str:
        parts = [f"{self.edges_read} edges read",
                 f"{self.edges_kept} kept",
                 f"{self.num_nodes} nodes"]
        for cat, n in self.filtered.items():
            parts.append(f"{n} filtered[{cat}]")
        if self.self_loops_removed:
            parts.append(f"{self.self_loops_removed} self-loops removed")
        if self.duplicates_removed:
            parts.append(f"{self.duplicates_removed} duplicates removed")
        return ", ".join(parts)


@dataclasses.dataclass
class IngestResult:
    graph: Graph
    idmap: NodeIdMapping
    stats: IngestStats
    virtual: VirtualLinks

    def open(self, config=None, *, device=None, **overrides):
        """A :class:`repro_torch.Session` on the ingested graph, with the
        id mapping attached so every output surface (``top_ranked``,
        serve top-k) speaks the file's original labels. ``device``
        defaults to ``"cuda"``, as ``repro_torch.open``'s does."""
        from .. import api
        return api.open(self.graph, config, idmap=self.idmap,
                        device=device, **overrides)

    def virtual_mass(self, ranks, damping: float = 0.85) -> Dict[str, float]:
        return self.virtual.interpret(ranks, self.idmap, self.graph,
                                      damping)


def dedup_edges(s: np.ndarray, d: np.ndarray):
    """Exact dedup of int32 edges over packed int64 keys ``src << 32 |
    dst``: ``(src, dst, removed)``, sorted by (src, dst) when anything was
    removed and as given otherwise. The JAX package's ``np.unique``, as
    one sort and a neighbour compare: numpy 2.3 and later take a hash
    table in ``np.unique`` on integers, which is many times slower than
    the sort when most keys are distinct, as edges are."""
    packed = np.sort((s.astype(np.int64) << 32) | d.astype(np.int64))
    first = np.empty(packed.size, dtype=bool)
    first[:1] = True
    np.not_equal(packed[1:], packed[:-1], out=first[1:])
    uniq = packed[first]
    if uniq.size == packed.size:
        return s, d, 0
    return ((uniq >> 32).astype(np.int32),
            (uniq & 0xFFFFFFFF).astype(np.int32),
            int(packed.size - uniq.size))


def ingest_edge_list(source, *,
                     filters: Sequence[LinkFilter] = (),
                     self_loops: str = "keep",
                     dedup: bool = False,
                     delimiter: Optional[str] = None,
                     comments: Sequence[str] = DEFAULT_COMMENTS,
                     chunk_edges: int = DEFAULT_CHUNK_EDGES,
                     idmap: Optional[NodeIdMapping] = None,
                     ) -> IngestResult:
    """Stream ``source`` through the full pipeline into an
    :class:`IngestResult`.

    ``self_loops``: ``"keep"`` leaves them in the graph, ``"drop"``
    removes and counts them, ``"virtual"`` removes them and tracks
    them under the ``"self_loops"`` virtual category.  Pass an
    existing ``idmap`` to ingest into an established id space
    (incremental loads); by default a fresh mapping is built.
    """
    if self_loops not in SELF_LOOP_POLICIES:
        raise ValueError(f"self_loops must be one of "
                         f"{SELF_LOOP_POLICIES}; got {self_loops!r}")
    names = [f.name for f in filters]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate filter names: {names}")
    if idmap is None:
        idmap = NodeIdMapping()
    stats = IngestStats(filtered={f.name: 0 for f in filters})
    virtual = VirtualLinks()
    int_src: list = []
    int_dst: list = []

    for src, dst in iter_edge_chunks(source, delimiter=delimiter,
                                     comments=comments,
                                     chunk_edges=chunk_edges):
        stats.edges_read += src.size
        for f in filters:
            mask = f(src, dst)
            if not mask.all():
                stats.filtered[f.name] += int((~mask).sum())
                if f.virtual:
                    virtual.add(f.name, src[~mask], dst[~mask])
                src, dst = src[mask], dst[mask]
            if not src.size:
                break
        if self_loops != "keep" and src.size:
            loops = src == dst
            if loops.any():
                stats.self_loops_removed += int(loops.sum())
                if self_loops == "virtual":
                    virtual.add(SELF_LOOP_CATEGORY, src[loops],
                                dst[loops])
                src, dst = src[~loops], dst[~loops]
        if src.size:
            int_src.append(idmap.map_chunk(src))
            int_dst.append(idmap.map_chunk(dst))

    if idmap.num_nodes == 0:
        raise ValueError(
            "ingest produced an empty graph: no edges survived "
            "parsing + filtering (check the source file, the filter "
            "predicates, and the self-loop policy)")
    s = np.concatenate(int_src).astype(np.int32, copy=False)
    d = np.concatenate(int_dst).astype(np.int32, copy=False)
    if dedup:
        s, d, stats.duplicates_removed = dedup_edges(s, d)
    stats.edges_kept = int(s.size)
    stats.num_nodes = idmap.num_nodes
    graph = Graph(idmap.num_nodes, s, d)
    return IngestResult(graph=graph, idmap=idmap, stats=stats,
                        virtual=virtual)
