"""Device resolution for every entry point of the port.

The port runs on a CUDA card. ``"cuda"`` is the default; ``"cpu"`` is
taken only when the caller names it (the tests do). There is no silent
fallback: asking for CUDA on a machine without it raises.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` an entry point runs on (default ``"cuda"``).

    Raises ``RuntimeError`` when CUDA is requested, explicitly or by
    default, and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
