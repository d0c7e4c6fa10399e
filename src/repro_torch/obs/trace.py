"""Span tracer + flight recorder (a copy of the JAX package's
``obs/trace.py``, which imports no JAX; DESIGN.md §14).

A query's life crosses at least three threads — a gateway submit
thread (intake, cache probe, backlog), the device thread (admission,
chunk dispatch, readback, top-k) and possibly a push worker — so the
tracer uses EXPLICIT parents: a ``Span`` handle is passed along with
the work (rides the ``Query`` dataclass through the scheduler, the
pending tuple through the gateway backlog), never inferred from
thread-local ambient context. That makes well-nestedness a checkable
property instead of an accident of which thread ran the callback.

Spans are recorded into a ``FlightRecorder`` — a lock-protected
bounded ring buffer (``collections.deque(maxlen=N)``) — at END time,
so the buffer holds complete ``(t_start, t_end)`` intervals; instant
events are zero-duration spans recorded immediately. The ring is the
crash-forensics surface: bounded memory under storm load, oldest
records evicted first, dumpable as JSON-lines on demand and
automatically on quarantine/stepper failure and beside a scheduler
snapshot.

The schema (``TRACE_SCHEMA_VERSION``), the JSONL fields and the span
and event names are the JAX package's, so a dump from either package
reads the same: ``query`` (root) with ``backlog``/``queue``/``slot``/
``push`` children and ``intake``/``cache_hit``/``topk``/``readback``/
``terminal``/``resolve`` events; ``chunk`` (trace ``"device"``);
``rebind``, ``solve``, ``session_delta``, ``snapshot``, the plan events
``png_build``/``plan_build``/``plan_cache_hit``/``plan_patch`` and
``xla_compile`` (trace ``"plan"``); ``crash_dump`` (trace ``"crash"``).
The port compiles no XLA: its ``xla_compile`` event, kept under the JAX
package's name, marks the one build of a scheduler's chunk stepper.

The port records spans of its own besides (``PORT_SPANS``), which the
JAX package lacks: the stages of a fused solve under ``solve``
(``solve_start``, ``solve_launch``, ``solve_readback``) and host
preprocessing (trace ``"plan"``: ``plan_make`` with its ``plan_stage``
children, ``device_layout``, ``kernel_load``). A reordered plan's
``plan_make`` holds the stages ``reorder`` (the permutation; attribute
``ordering``) and ``relabel`` (the relabeled graph); a built plan with a
PNG carries ``updates``, ``r`` and ``max_part_share`` (the heaviest
partition's share of the arcs); ``solve`` carries the plan's
``reorder``. While a
``torch.profiler`` session records, each of them and ``solve`` also
opens a profiler range named ``repro_torch::<name>`` from its start to
its end, so the profiler stamps the span on the clock of its aten ops
and device kernels (the recorder's own times are ``perf_counter``).

Overhead discipline: with observability off no Span objects exist and
every hot-path hook is one ``is None`` branch. With it on, a span is
one small object + one deque append under a lock held for O(1).
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

import torch

TRACE_SCHEMA_VERSION = 1

# the port's own span names, recorded beside the JAX package's schema
PORT_SPANS = frozenset({"solve_start", "solve_launch", "solve_readback",
                        "plan_make", "plan_stage", "device_layout",
                        "kernel_load"})
# spans that open a profiler range while torch.profiler records
PROFILED_SPANS = PORT_SPANS | {"solve"}

_ids = itertools.count(1)


def _next_id() -> int:
    # next() on an itertools.count is atomic under the GIL — no lock on
    # the one allocation every span and event pays
    return next(_ids)


def profiler_range(name: str):
    """An open ``repro_torch::<name>`` range while a ``torch.profiler``
    session records, else None; ``Span.end`` closes it.
    ``_RecordFunctionFast`` puts the range on the profiler's host
    timeline only: ``record_function``'s would also be copied onto the
    device timeline (``gpu_user_annotation``), where a union of device
    intervals would count it as device time."""
    if not torch._C._autograd._profiler_enabled():
        return None
    rng = torch._C._profiler._RecordFunctionFast("repro_torch::" + name)
    rng.__enter__()
    return rng


class SpanRecord:
    """Immutable-after-record row in the flight recorder."""

    __slots__ = ("name", "span_id", "parent_id", "trace", "t_start",
                 "t_end", "status", "attrs")

    def __init__(self, name, span_id, parent_id, trace, t_start, t_end,
                 status, attrs):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace = trace
        self.t_start = t_start
        self.t_end = t_end
        self.status = status
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def is_event(self) -> bool:
        return self.t_end == self.t_start

    def to_dict(self) -> dict:
        return {"name": self.name, "span": self.span_id,
                "parent": self.parent_id, "trace": self.trace,
                "t0": self.t_start, "t1": self.t_end,
                "status": self.status, "attrs": self.attrs}

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, trace={self.trace!r}, "
                f"span={self.span_id}, parent={self.parent_id}, "
                f"status={self.status!r}, dur={self.duration_s:.6f})")


class FlightRecorder:
    """Bounded ring of SpanRecords; oldest evicted first."""

    def __init__(self, capacity: int = 8192):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.recorded = 0          # total ever recorded
        self.dropped = 0           # evicted by ring pressure

    def record(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(rec)
            self.recorded += 1

    def snapshot(self) -> list:
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def to_jsonl(self) -> str:
        recs = self.snapshot()
        header = {"schema": TRACE_SCHEMA_VERSION,
                  "recorded": self.recorded, "dropped": self.dropped,
                  "capacity": self.capacity, "held": len(recs)}
        lines = [json.dumps(header)]
        lines.extend(json.dumps(r.to_dict(), default=str) for r in recs)
        return "\n".join(lines) + "\n"

    def dump(self, path: str) -> str:
        """Write the ring as JSON-lines: one header line (schema,
        recorded/dropped totals) then one record per line, oldest
        first.  Returns ``path``."""
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return path


class Span:
    """Open interval; becomes visible in the recorder on ``end()``."""

    __slots__ = ("_tracer", "name", "span_id", "parent_id", "trace",
                 "t_start", "attrs", "_done", "_range")

    def __init__(self, tracer, name, parent_id, trace, t_start, attrs):
        self._tracer = tracer
        self.name = name
        self.span_id = _next_id()
        self.parent_id = parent_id
        self.trace = trace
        self.t_start = t_start
        self.attrs = attrs
        self._done = False
        self._range = (profiler_range(name) if name in PROFILED_SPANS
                       else None)

    def bind(self, trace) -> None:
        """Late-bind the trace id (a query's uid is allocated under
        the scheduler intake lock, after the gateway already opened
        the root span)."""
        self.trace = trace

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def event(self, name: str, **attrs):
        """Zero-duration child, recorded immediately."""
        return self._tracer.event(name, parent=self, trace=self.trace,
                                  **attrs)

    def child(self, name: str, **attrs) -> "Span":
        return self._tracer.start(name, parent=self, trace=self.trace,
                                  **attrs)

    def end(self, status: str = "ok", **attrs) -> None:
        """Record the span.  Idempotent: a second ``end`` is a counted
        no-op (``tracer.double_ends``), never a duplicate record — the
        flight recorder's exactly-once guarantee lives here."""
        if self._done:
            self._tracer.double_ends += 1
            return
        self._done = True
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if attrs:
            self.attrs.update(attrs)
        self._tracer.recorder.record(SpanRecord(
            self.name, self.span_id, self.parent_id, self.trace,
            self.t_start, self._tracer.clock(), status, self.attrs))

    @property
    def ended(self) -> bool:
        return self._done


class Tracer:
    def __init__(self, recorder: Optional[FlightRecorder] = None, *,
                 clock=time.perf_counter):
        self.recorder = recorder if recorder is not None else FlightRecorder()
        self.clock = clock
        self.double_ends = 0

    @staticmethod
    def _parent_id(parent) -> Optional[int]:
        if parent is None:
            return None
        return parent.span_id if isinstance(parent, Span) else int(parent)

    def start(self, name: str, *, parent=None, trace=None,
              **attrs) -> Span:
        if trace is None and isinstance(parent, Span):
            trace = parent.trace
        return Span(self, name, self._parent_id(parent), trace,
                    self.clock(), attrs)

    def event(self, name: str, *, parent=None, trace=None,
              status: str = "ok", **attrs) -> SpanRecord:
        if trace is None and isinstance(parent, Span):
            trace = parent.trace
        t = self.clock()
        rec = SpanRecord(name, _next_id(), self._parent_id(parent),
                         trace, t, t, status, attrs)
        self.recorder.record(rec)
        return rec

    @contextmanager
    def span(self, name: str, *, parent=None, trace=None, **attrs):
        sp = self.start(name, parent=parent, trace=trace, **attrs)
        try:
            yield sp
        except BaseException as e:
            sp.end(status="error", error=f"{type(e).__name__}: {e}")
            raise
        sp.end()


class QuerySpans:
    """Per-query span bundle threaded through gateway and scheduler.

    Holds the root ``query`` span plus at most one open child per
    phase name (``backlog``/``queue``/``slot``/``push``).  Terminal
    discipline: ``finish()`` closes any open children, records exactly
    one ``terminal`` event, and ends the root — unless the bundle is
    ``gateway_owned``, in which case the root stays open until the
    gateway resolves the caller-visible future (``resolve()``), so the
    recorded root interval covers the FULL client-observed latency.
    """

    __slots__ = ("tracer", "root", "children", "gateway_owned",
                 "terminals")

    def __init__(self, tracer: Tracer, root: Span, *,
                 gateway_owned: bool = False):
        self.tracer = tracer
        self.root = root
        self.children: dict = {}
        self.gateway_owned = gateway_owned
        self.terminals = 0

    def bind(self, uid) -> None:
        self.root.bind(uid)
        for sp in self.children.values():
            sp.bind(uid)

    def event(self, name: str, **attrs) -> None:
        self.root.event(name, **attrs)

    def start_child(self, name: str, **attrs) -> Span:
        """Open a phase child; an already-open child of the same name
        is closed with status ``retry`` first (quarantine re-admits
        open a second ``slot`` span)."""
        prev = self.children.get(name)
        if prev is not None and not prev.ended:
            prev.end(status="retry")
        sp = self.root.child(name, **attrs)
        self.children[name] = sp
        return sp

    def end_child(self, name: str, status: str = "ok", **attrs) -> None:
        sp = self.children.get(name)
        if sp is not None and not sp.ended:
            sp.end(status=status, **attrs)

    def finish(self, status: str = "ok", **attrs) -> None:
        """The query reached a terminal state in the scheduler (or the
        gateway rejected/cache-served it)."""
        for name, sp in self.children.items():
            if not sp.ended:
                sp.end(status=status if status != "ok" else "ok")
        self.terminals += 1
        self.root.event("terminal", status=status, **attrs)
        if not self.gateway_owned:
            self.root.end(status)

    def resolve(self, **attrs) -> None:
        """Gateway-side: the caller-visible future was fulfilled."""
        if self.gateway_owned and not self.root.ended:
            self.root.event("resolve", **attrs)
            self.root.end()
