from .partition import Partitioning, partition_for_vmem
from .png import (PNGLayout, BlockedPNG, GatherSchedule, build_png,
                  block_png, build_gather_schedule,
                  flat_gather_schedule)
from .plan import (GraphPlan, PlanConfig, build_plan, clear_plan_cache,
                   evict_plans, graph_fingerprint, install_plan,
                   plan_cache_stats, plan_from_arrays, plan_nbytes,
                   validate_plan)
from .backends import (Backend, available_backends, get_backend,
                       register_backend, resolve_engine, resolve_method)
from .spmv import (SpMVEngine, pdpr_spmv, pcpm_spmv, pcpm_scatter,
                   pcpm_gather, pcpm_gather_blocked, bvgas_scatter,
                   bvgas_gather, pcpm_spmv_weighted, DevicePNG,
                   DeviceCSC, DeviceBVGAS)
from .pagerank import (pagerank, pagerank_reference, PageRankResult,
                       fused_power_iteration, masked_chunk_stepper)
from . import comm_model

__all__ = [
    "Partitioning", "partition_for_vmem", "PNGLayout", "BlockedPNG",
    "GatherSchedule", "build_png", "block_png", "build_gather_schedule",
    "flat_gather_schedule",
    "GraphPlan", "PlanConfig", "build_plan", "clear_plan_cache",
    "evict_plans", "graph_fingerprint", "install_plan",
    "plan_cache_stats", "plan_from_arrays", "plan_nbytes", "validate_plan",
    "Backend", "available_backends", "get_backend", "register_backend",
    "resolve_engine", "resolve_method",
    "SpMVEngine", "pdpr_spmv", "pcpm_spmv", "pcpm_scatter",
    "pcpm_gather", "pcpm_gather_blocked", "bvgas_scatter",
    "bvgas_gather", "pcpm_spmv_weighted", "DevicePNG", "DeviceCSC",
    "DeviceBVGAS", "pagerank",
    "pagerank_reference", "PageRankResult", "fused_power_iteration",
    "masked_chunk_stepper", "comm_model",
]
