"""Async serving gateway (a port of the JAX package's ``gateway/``;
DESIGN.md §13).

``Gateway`` is the threaded front door over the synchronous
``SlotScheduler`` core: one device thread owns all stepping, a worker
pool answers push-eligible queries inline, ``submit()`` returns a future
at once, and a warm-result LRU serves repeats in O(k).
``GraphRegistry.gateway()`` / ``Session.gateway()`` are the usual
constructors.
"""
from .autotune import AutotuneReport, autotune_slots
from .cache import ResultCache, seed_digest
from .frontdoor import Gateway, GatewayConfig
from .qos import WeightedFair

__all__ = ["Gateway", "GatewayConfig", "ResultCache", "seed_digest",
           "AutotuneReport", "autotune_slots", "WeightedFair"]
