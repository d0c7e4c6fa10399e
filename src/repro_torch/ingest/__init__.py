"""Real-graph ingest (a port of the JAX package's ``ingest``; DESIGN.md
§12): bytes on disk -> served plan.

Streaming SNAP/TSV edge-list parsing (plain or gzip, never materializing
the file), arbitrary 64-bit or string external ids mapped to dense int32
internal ids (``NodeIdMapping``, persisted beside the plan ``.npz``),
and composable pipeline stages — predicate link filters, self-loop and
duplicate policy, and virtual links, so filtered edges' PageRank mass is
reported instead of silently dropped.

    from repro_torch.ingest import ingest_edge_list, LinkFilter
    res = ingest_edge_list("web.txt.gz",
                           filters=[LinkFilter("offsite",
                                               lambda s, d: d < 10**6)],
                           self_loops="drop", dedup=True)
    sess = res.open(reorder="hybrid")       # a Session with external ids
    sess.pagerank()
    sess.top_ranked(10)                     # ids in the FILE's labels
"""
from .idmap import NodeIdMapping
from .parse import ParseError, iter_edge_chunks, read_edge_list
from .pipeline import (IngestResult, IngestStats, LinkFilter,
                       VirtualLinks, ingest_edge_list)

__all__ = [
    "NodeIdMapping", "ParseError", "iter_edge_chunks", "read_edge_list",
    "IngestResult", "IngestStats", "LinkFilter", "VirtualLinks",
    "ingest_edge_list",
]
