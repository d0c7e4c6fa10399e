"""Deterministic synthetic LM data, the counterpart of the JAX package's
``data/tokens.py``.

Token streams are a keyed hash of (stream seed, step, position), so any
worker can make its share of any batch on its own and a restart seeks
to a step instead of restoring a loader's state. The hash is the
reference's (splitmix64-style, numpy ``uint64``), so the tokens are
equal value for value.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _hash_tokens(seed: int, step: int, batch: int, seq: int,
                 vocab: int) -> np.ndarray:
    # splitmix64-style mixing, vectorized
    with np.errstate(over="ignore"):
        idx = (np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
               + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9)
               + np.arange(batch * seq, dtype=np.uint64))
    z = idx
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(vocab)).astype(np.int32).reshape(batch, seq)


def synthetic_lm_batches(vocab: int, batch: int, seq: int, *,
                         seed: int = 0, start_step: int = 0, device=None):
    """Infinite iterator of {"tokens", "labels"} (B, S) int32 tensors on
    ``device`` (default ``"cuda"``); labels are the next tokens."""
    dev = resolve_device(device)
    step = start_step
    while True:
        toks = torch.from_numpy(_hash_tokens(seed, step, batch, seq + 1,
                                             vocab)).to(dev)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step += 1
