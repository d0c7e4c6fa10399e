"""The host side of a kernel launch, shared by the wrappers of B1 and B2.

A launch of a small kernel is over in a few microseconds on the card, so
what its wrapper does in Python sets its time. Each step here is the
cheap form of one that a wrapper otherwise repeats on every call:

- ``check_hopper``: the compute capability is asked once per device and
  kernel, not on every call;
- ``device_guard``: no ``torch.cuda.device`` context is entered when the
  tensor's device is already the current one;
- ``raw_stream``: the current stream's handle, without building a
  ``torch.cuda.Stream`` object;
- ``Args``: a kernel's scalar arguments and pointers packed into one
  buffer of int64 values, in the order the C side reads them, so
  ``ctypes`` converts two arguments (the buffer and the stream) instead
  of twenty.
"""
from __future__ import annotations

import contextlib
import functools
import struct

import torch


@functools.cache
def check_hopper(device: torch.device, kernel: str) -> None:
    """Raise unless ``device`` is a compute capability 9.0 card (the
    kernels are built for sm_90a). Cached on success only, so a wrong
    card raises on every call."""
    capability = torch.cuda.get_device_capability(device)
    if capability != (9, 0):
        raise RuntimeError(
            f"the {kernel} kernel is built for sm_90a (Hopper); device "
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{capability}")


def device_guard(device: torch.device):
    """The context a launch on ``device`` needs: none when it is the
    calling thread's current device, else ``torch.cuda.device``."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


class Args:
    """A C interface's arguments as one buffer of int64 values. ``names``
    are the fields in the order of the source's ``enum Arg``; ``pack``
    takes the values in that order (a wrong count raises) and returns the
    bytes to pass as a ``const long long*``."""

    def __init__(self, *names: str):
        self.names = names
        self._struct = struct.Struct(f"{len(names)}q")

    def pack(self, *values: int) -> bytes:
        return self._struct.pack(*values)

    def unpack(self, buffer: bytes) -> dict[str, int]:
        """The values of a packed buffer by name, as the C side reads
        them."""
        return dict(zip(self.names, self._struct.unpack(buffer)))
