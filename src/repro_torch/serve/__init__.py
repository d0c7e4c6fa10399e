"""Serving: LM continuous batching (``ServeEngine``). PageRank serving
comes with its slice (ROADMAP.md, Queue A item 8)."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
