"""Frozen graph generators of the benchmark, one module a generator.

Each module has ``make(config, seed, device) -> (n, src, dst)``: the
node count and the arcs as int32 tensors on ``device``, drawn on the
device from ``seed`` in a few large calls. A seed gives the same arrays
on the same device type and PyTorch version (the card's Philox stream
and the CPU's Mersenne Twister differ).
"""
from __future__ import annotations

import torch


def torch_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number (reduced
    modulo 2**64, which ``manual_seed`` takes)."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) % (1 << 64))
    return gen
