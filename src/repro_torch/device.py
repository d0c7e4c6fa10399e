"""Device resolution for every entry point of the port.

The port runs on a CUDA card. ``"cuda"`` is the default; ``"cpu"`` is
taken only when the caller names it (the tests do). There is no silent
fallback: asking for CUDA on a machine without it raises.
"""
from __future__ import annotations

import numpy as np
import torch

# what ``jnp.asarray`` makes of 64-bit input with JAX's default x64 off
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}
_NARROW_TORCH = {torch.float64: torch.float32, torch.int64: torch.int32,
                 torch.complex128: torch.complex64}


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


def as_device_tensor(x, device) -> torch.Tensor:
    """``x`` (a tensor, numpy array or nested sequence) as a tensor on
    ``device``, with 64-bit types narrowed as the JAX package's
    ``jnp.asarray`` narrows them (float64 to float32, int64 to int32):
    the port's entry points take the same host input the reference
    takes and compute in the same types. The cast happens before the
    copy to the device."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=_NARROW_TORCH.get(x.dtype, x.dtype)).to(device)
    arr = np.asarray(x)
    narrow = _NARROW.get(arr.dtype)
    if narrow is not None:
        arr = arr.astype(narrow)
    return torch.as_tensor(arr, device=device)
