from .formats import Graph, from_edge_list, validate_graph
from . import generators, io, reorder, sampler

__all__ = ["Graph", "from_edge_list", "validate_graph", "generators",
           "io", "reorder", "sampler"]
