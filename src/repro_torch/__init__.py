"""PyTorch/CUDA port of the PCPM PageRank system — public API.

    import repro_torch
    sess = repro_torch.open(g, repro_torch.EngineConfig(method="pcpm"))
    res  = sess.pagerank()

Runs on a CUDA card by default (``device="cuda"``) and raises without
one; pass ``device="cpu"`` to run on the CPU. The plan/run split lives
in ``repro_torch.core.plan`` (one immutable ``GraphPlan`` per (graph,
config), process-cached) and ``repro_torch.core.backends`` (the engine
registry). The PCPM gather phase of the ``pcpm_pallas`` engine is a
CUDA kernel (``repro_torch/csrc/pcpm_gather.cu``). Streaming edge deltas
(``GraphDelta``, ``Session.apply_delta``, ``pagerank(warm=True)``) live
in ``repro_torch.stream``; fault injection, scheduler snapshots and rank
checkpoints in ``repro_torch.reliability``; edge-list ingest with
external ids (``ingest_edge_list``, ``NodeIdMapping``) in
``repro_torch.ingest``; the async front door (``Gateway``,
``Session.gateway()``: futures, a warm-result cache, slot autotune,
weighted-fair QoS) in ``repro_torch.gateway``; span tracing, the flight
recorder, metrics and measured comm (``Observability``,
``Session.observe()``) in ``repro_torch.obs``; the sharded path
(``EngineConfig(method="pcpm_sharded")``, one process per card over the
caller's ``torch.distributed`` group) in ``repro_torch.core.distributed``.

LM serving lives in ``repro_torch.configs``, ``repro_torch.models``
(``transformer``: ``init_lm``, ``forward``, ``prefill``,
``decode_step``) and ``repro_torch.serve`` (``ServeEngine``); its
attention is the CUDA kernel ``repro_torch/csrc/flash_attention.cu``.
LM training adds ``transformer.lm_loss``/``make_train_step``,
``repro_torch.optim`` (``AdamW``), ``repro_torch.train`` (``Trainer``,
checkpoints, gradient compression), ``repro_torch.data``
(``synthetic_lm_batches``) and ``python -m repro_torch.launch.train``;
the attention's backward is ``repro_torch/csrc/flash_attention_bwd.cu``.

Recsys serving (MIND) lives in ``repro_torch.models.recsys``
(``init_mind``, ``serve_step``, ``retrieval_step``); every embedding
lookup is the CUDA kernel ``repro_torch/csrc/embedding_bag.cu``.
"""
from .api import EngineConfig, Session, open
from .core.backends import (Backend, available_backends, get_backend,
                            register_backend)
from .core.plan import (GraphPlan, PlanConfig, build_plan,
                        clear_plan_cache, evict_plans, install_plan,
                        plan_cache_stats, plan_from_arrays)
from .device import resolve_device
from .gateway import Gateway, GatewayConfig
from .ingest import (LinkFilter, NodeIdMapping, VirtualLinks,
                     ingest_edge_list)
from .obs import (FlightRecorder, MetricsRegistry, Observability,
                  Tracer)
from .reliability import ResilienceConfig, check_plan_integrity
from .stream import DynamicGraph, GraphDelta

__all__ = [
    "EngineConfig", "Session", "open",
    "Backend", "available_backends", "get_backend", "register_backend",
    "GraphPlan", "PlanConfig", "build_plan", "clear_plan_cache",
    "evict_plans", "install_plan", "plan_cache_stats", "plan_from_arrays",
    "resolve_device", "ResilienceConfig", "check_plan_integrity",
    "DynamicGraph", "GraphDelta",
    "LinkFilter", "NodeIdMapping", "VirtualLinks", "ingest_edge_list",
    "Gateway", "GatewayConfig",
    "FlightRecorder", "MetricsRegistry", "Observability", "Tracer",
]
