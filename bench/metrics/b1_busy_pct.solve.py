"""Kernel B1's device time (``csrc/pcpm_gather.cu``: its "tile" and
"warp" ``gather_kernel``s) over all device time in the traced window of
solves, from torch.profiler's kernel names."""


def is_b1(name: str) -> bool:
    return "gather_kernel" in name and ("tile::" in name or "warp::" in name)


def read(run):
    tr = run.devtrace
    if tr is None or not tr.busy_s or run.extra.get("solves") is None:
        return None
    b1 = tr.device_seconds(is_b1)
    if b1 is None:
        return None
    total = sum(v[0] for v in tr.kernels.values())
    return 100.0 * b1[0] / total
