"""The device trace of a window, from ``torch.profiler``.

``DeviceTrace.start()``/``stop()`` bracket the traced window (both
synchronize the card). ``reduce()`` then reads the profiler's events:
the device's busy seconds as the union of its kernel, copy and set
intervals; device time and count by kernel name; and the idle gaps
between device intervals, each named by the innermost host operation
running at its midpoint.
"""
from __future__ import annotations

import re
import time

import torch

NAME_CHARS = 120


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its argument list."""
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i in range(len(name) - 1, -1, -1):
        ch = name[i]
        if ch == ")":
            depth += 1
        elif ch == "(":
            depth -= 1
            if depth == 0:
                cut = i
                break
    if cut > 0 and name.endswith(")"):
        name = name[:cut]
    return name[:NAME_CHARS]


class DeviceTrace:
    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t0 = self.t1 = None
        self.busy_s = None
        self.window_s = None
        self.kernels: dict[str, list] = {}      # name -> [seconds, count]
        self.gaps: dict[str, float] = {}        # host op -> idle seconds

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """A throwaway trace of one small device operation, in set-up: the
        profiler's first start initializes its device tracing, which
        stalls the process for seconds and would otherwise fall inside
        the traced window."""
        prof = self._profile()
        prof.start()
        torch.ones(1024, device=self.device).add_(1.0)
        self._sync()
        prof.stop()

    def start(self) -> None:
        self._sync()
        self.prof = self._profile()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def reduce(self) -> None:
        """Reads the events once the window has closed."""
        self.window_s = self.t1 - self.t0
        device_type = torch.autograd.DeviceType
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            if e.device_type() == device_type.CUDA:
                dev.append((t0, t1, e.name()))
            elif e.device_type() == device_type.CPU and t1 > t0:
                host.append((t0, t1, e.name()))
        self.prof = None
        if not dev:
            return
        dev.sort()
        busy = 0
        spans = []
        cur0, cur1 = dev[0][0], dev[0][1]
        for t0, t1, name in dev:
            entry = self.kernels.setdefault(short_name(name), [0.0, 0])
            entry[0] += (t1 - t0) * 1e-9
            entry[1] += 1
            if t0 > cur1:
                spans.append((cur0, cur1))
                cur0, cur1 = t0, t1
            else:
                cur1 = max(cur1, t1)
        spans.append((cur0, cur1))
        busy = sum(b - a for a, b in spans)
        self.busy_s = busy * 1e-9
        host.sort()
        starts = [h[0] for h in host]
        import bisect
        for (_, a), (b, _) in zip(spans[:-1], spans[1:]):
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid)
            name = "no traced host op"
            # the innermost op running at the midpoint: the latest start
            # among those that have not ended
            for j in range(i - 1, max(-1, i - 2000), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            self.gaps[name] = self.gaps.get(name, 0.0) + (b - a) * 1e-9

    def device_seconds(self, match) -> tuple[float, int] | None:
        """(seconds, launches) of the kernels whose short name
        ``match(name)`` accepts; None when none ran."""
        hits = [v for k, v in self.kernels.items() if match(k)]
        if not hits:
            return None
        return sum(h[0] for h in hits), sum(h[1] for h in hits)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def idle_pct(trace: DeviceTrace | None) -> float | None:
    """100 - the device's busy share of the traced window; None without
    a trace that saw the device."""
    if trace is None or not trace.busy_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
