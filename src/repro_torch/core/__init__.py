from .partition import Partitioning
from .png import (PNGLayout, BlockedPNG, GatherSchedule, build_png,
                  block_png, build_gather_schedule,
                  flat_gather_schedule)
from .plan import (GraphPlan, PlanConfig, build_plan, clear_plan_cache,
                   graph_fingerprint, install_plan, plan_cache_stats,
                   plan_from_arrays, validate_plan)
from .backends import (Backend, available_backends, get_backend,
                       register_backend)
from .spmv import (SpMVEngine, pdpr_spmv, pcpm_spmv, pcpm_scatter,
                   pcpm_gather, pcpm_gather_blocked, bvgas_scatter,
                   bvgas_gather, pcpm_spmv_weighted)
from .pagerank import (pagerank, pagerank_reference, PageRankResult,
                       fused_power_iteration)

__all__ = [
    "Partitioning", "PNGLayout", "BlockedPNG", "GatherSchedule",
    "build_png", "block_png", "build_gather_schedule",
    "flat_gather_schedule",
    "GraphPlan", "PlanConfig", "build_plan", "clear_plan_cache",
    "graph_fingerprint", "install_plan", "plan_cache_stats",
    "plan_from_arrays", "validate_plan",
    "Backend", "available_backends", "get_backend", "register_backend",
    "SpMVEngine", "pdpr_spmv", "pcpm_spmv", "pcpm_scatter",
    "pcpm_gather", "pcpm_gather_blocked", "bvgas_scatter",
    "bvgas_gather", "pcpm_spmv_weighted", "pagerank",
    "pagerank_reference", "PageRankResult", "fused_power_iteration",
]
