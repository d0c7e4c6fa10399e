"""The byte floor of one PageRank SpMV and the table of peaks.

The floor is counted from the graph, not from any layout, so that a
change of layout or kernel cannot make it stale: one iteration at
width d reads at least one 4-byte index an arc, the (n + 1) 4-byte
offsets, and each rank once, and writes each rank once (float32):
``4 m + 4 (n + 1) + 8 n d`` bytes. Its time is those bytes over the
card's published memory bandwidth.
"""
from __future__ import annotations

# published HBM bandwidth, bytes/s, by the name torch.cuda.get_device_name
# gives (NVIDIA's data sheet for the H100 SXM: 3.35 TB/s)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def spmv_floor_bytes(n: int, m: int, d: int) -> int:
    return 4 * m + 4 * (n + 1) + 8 * n * d


def spmv_floor_s(n: int, m: int, d: int, kind: str) -> float | None:
    """Seconds of the byte floor on the card named ``kind``; None for a
    card the table does not hold."""
    peak = PEAK_BYTES_PER_S.get(kind)
    if peak is None:
        return None
    return spmv_floor_bytes(n, m, d) / peak


def roofline_pct(run) -> float | None:
    """The byte floor of the SpMV passes in the traced window over the
    device time of every kernel there, in percent; None without a trace
    that saw the device, without passes, or on a card the table lacks."""
    trace = run.devtrace
    if trace is None or not trace.busy_s or not run.trace_passes:
        return None
    floor = spmv_floor_s(run.n, run.m, run.trace_width,
                         run.extra.get("device_kind"))
    if floor is None:
        return None
    return 100.0 * run.trace_passes * floor / trace.busy_s
