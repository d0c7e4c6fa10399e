"""Serving: PageRank queries (``PageRankServer``, the continuous-
batching ``SlotScheduler`` and ``GraphRegistry``, forward push, top-k,
metrics) and LM continuous batching (``ServeEngine``)."""
from .engine import PageRankServer, Request, ServeEngine
from .metrics import QueryTrace, ServeMetrics
from .push import PushQueryEngine, PushResult
from .scheduler import GraphRegistry, Query, QueryResult, SlotScheduler
from .topk import host_topk, make_slot_topk, slot_topk, topk_ranks

__all__ = [
    "PageRankServer", "ServeEngine", "Request",
    "SlotScheduler", "GraphRegistry", "Query", "QueryResult",
    "ServeMetrics", "QueryTrace", "PushQueryEngine", "PushResult",
    "host_topk", "make_slot_topk", "slot_topk", "topk_ranks",
]
