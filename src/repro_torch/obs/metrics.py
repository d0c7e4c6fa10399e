"""Typed metrics registry: the host-side home of the serving stack's
counters (a copy of the JAX package's ``obs/metrics.py``; no device work).

- ``Counter``   — monotone; ``inc(n)`` with ``n >= 0`` enforced.
- ``Gauge``     — last-write-wins level (queue depth, cache entries).
- ``Histogram`` — fixed upper-bound buckets with exact exposed-bucket
  semantics: ``observe(v)`` lands in the first bucket with
  ``v <= upper_bound`` (Prometheus ``le`` inclusive), the exported
  counts are cumulative, and ``sum``/``count`` are exact.

A ``MetricsRegistry`` is a named family table: ``registry.counter
("serve_events_total", event="rejected")`` gets or creates one child
per label set, and re-registering a name with a different type raises
``ValueError``. Registries export as Prometheus text
(``render_prometheus`` merges several under extra labels) and as JSON.

Every metric carries its own lock, so increments from several threads
never lose updates.
"""
from __future__ import annotations

import bisect
import threading

# Latency-shaped default buckets (seconds), sub-ms to 10 s — the
# serving stack's observed range from cache hits (~0.1 ms) to cold
# full-vector solves (seconds).
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    """Monotone event counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counters are monotone; inc({n}) < 0 "
                             "(use a Gauge for levels)")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with exact exposed-bucket semantics.

    ``bounds`` are finite ascending upper bounds; the implicit +Inf
    bucket is always present.  ``observe(v)`` increments the FIRST
    bucket with ``v <= bound`` — Prometheus ``le`` inclusive — and the
    exported per-bucket counts are cumulative.
    """

    __slots__ = ("bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds=DEFAULT_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(f"histogram bounds must be strictly "
                             f"ascending; got {bounds}")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # [+Inf] last
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        """``buckets`` is the exact exposed form: ``(le, cumulative)``
        pairs ending with ``("+Inf", count)``."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, buckets = 0, []
        for bound, c in zip(self.bounds, counts[:-1]):
            cum += c
            buckets.append((bound, cum))
        buckets.append(("+Inf", total))
        return {"buckets": buckets, "sum": s, "count": total}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create table of metric families keyed (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"kind": str, "help": str, "metrics": {labelkey: m}}
        self._families: dict[str, dict] = {}

    # ------------------------------------------------------------ create
    def _get(self, kind: str, name: str, help_: str, labels: dict,
             factory):
        key = tuple(sorted(labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = {"kind": kind, "help": help_, "metrics": {}}
                self._families[name] = fam
            elif fam["kind"] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{fam['kind']}; cannot re-register as {kind} "
                    "(type drift is how counters get double-homed)")
            m = fam["metrics"].get(key)
            if m is None:
                m = factory()
                fam["metrics"][key] = m
            if help_ and not fam["help"]:
                fam["help"] = help_
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels, Gauge)

    def histogram(self, name: str, help: str = "", *,
                  buckets=None, **labels) -> Histogram:
        return self._get("histogram", name, help, labels,
                         lambda: Histogram(buckets or DEFAULT_BUCKETS))

    # -------------------------------------------------------------- read
    def family_items(self, name: str) -> list[tuple[dict, object]]:
        """``(labels, metric)`` children of one family (empty list for
        an unknown name)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return []
            return [(dict(k), m) for k, m in fam["metrics"].items()]

    def counter_value(self, name: str, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            fam = self._families.get(name)
            m = fam["metrics"].get(key) if fam else None
        return m.value if m is not None else 0.0

    def collect(self) -> list[dict]:
        """Point-in-time snapshot of every family, render-ready."""
        with self._lock:
            fams = [(name, fam["kind"], fam["help"],
                     list(fam["metrics"].items()))
                    for name, fam in sorted(self._families.items())]
        out = []
        for name, kind, help_, metrics in fams:
            children = []
            for key, m in metrics:
                if kind == "histogram":
                    children.append((dict(key), m.snapshot()))
                else:
                    children.append((dict(key), m.value))
            out.append({"name": name, "kind": kind, "help": help_,
                        "metrics": children})
        return out

    def to_json(self) -> dict:
        """``{name: {kind, help, values: [{labels, value|histogram}]}}``
        — what benchmark rows and ``Session.stats()`` embed."""
        doc = {}
        for fam in self.collect():
            doc[fam["name"]] = {
                "kind": fam["kind"], "help": fam["help"],
                "values": [
                    {"labels": labels,
                     **({"histogram": {
                          "buckets": [[str(le), c] for le, c
                                      in v["buckets"]],
                          "sum": v["sum"], "count": v["count"]}}
                        if fam["kind"] == "histogram"
                        else {"value": v})}
                    for labels, v in fam["metrics"]],
            }
        return doc

    def prometheus_text(self) -> str:
        return render_prometheus([(self, {})])


# ---------------------------------------------------------------------------
# Prometheus text rendering
# ---------------------------------------------------------------------------
def _escape(v) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labelstr(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(pairs: list[tuple[MetricsRegistry, dict]]) -> str:
    """Merge several registries into one Prometheus text exposition;
    each registry's samples gain its ``extra`` labels (the gateway
    labels per-scheduler registries with ``graph=<name>``).  Duplicate
    registry objects are emitted once (first extra-labels win)."""
    fams: dict[str, dict] = {}       # name -> {kind, help, samples}
    seen: set[int] = set()
    for reg, extra in pairs:
        if id(reg) in seen:
            continue
        seen.add(id(reg))
        for fam in reg.collect():
            slot = fams.setdefault(
                fam["name"], {"kind": fam["kind"], "help": fam["help"],
                              "samples": []})
            if slot["kind"] != fam["kind"]:
                raise ValueError(
                    f"metric {fam['name']!r} exported as both "
                    f"{slot['kind']} and {fam['kind']}")
            for labels, v in fam["metrics"]:
                slot["samples"].append(({**labels, **extra}, v))
    lines = []
    for name in sorted(fams):
        fam = fams[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for labels, v in fam["samples"]:
            if fam["kind"] == "histogram":
                for le, cum in v["buckets"]:
                    le_s = "+Inf" if le == "+Inf" else _num(le)
                    lines.append(
                        f"{name}_bucket"
                        f"{_labelstr({**labels, 'le': le_s})} {cum}")
                lines.append(f"{name}_sum{_labelstr(labels)} "
                             f"{_num(v['sum'])}")
                lines.append(f"{name}_count{_labelstr(labels)} "
                             f"{v['count']}")
            else:
                lines.append(f"{name}{_labelstr(labels)} {_num(v)}")
    return "\n".join(lines) + "\n"
