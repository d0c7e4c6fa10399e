"""Gradient compression: int8 error-feedback quantization, the
counterpart of the JAX package's ``train/compression.py``.

Over a slow link the gradient all-reduce's bytes dominate; int8 with
error feedback cuts them 4x, and the error accumulator re-injects each
step's quantization residual into the next. ``compress``/``decompress``
keep shapes; the trees here are dicts keyed by parameter name, and the
trainer threads an ``ef_state`` dict through its steps. Rounding is half to even, as
``jnp.round``'s.
"""
from __future__ import annotations

import torch


def init_ef_state(grads) -> dict:
    """A float32 zero error accumulator beside each gradient (or
    parameter) of ``grads``."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def compress(x: torch.Tensor, ef: torch.Tensor):
    """x (+ carried error) -> (int8 q, float32 scale, new error)."""
    xc = x.float() + ef
    scale = xc.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xc / scale), -127, 127).to(torch.int8)
    err = xc - q.float() * scale
    return q, scale, err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, ef_state):
    """(qs, scales, errs), dicts keyed like ``grads``."""
    out = {n: compress(g, ef_state[n]) for n, g in grads.items()}
    return ({n: o[0] for n, o in out.items()},
            {n: o[1] for n, o in out.items()},
            {n: o[2] for n, o in out.items()})


def decompress_tree(qs, scales):
    return {n: decompress(q, scales[n]) for n, q in qs.items()}


def compressed_gradients(grads, ef_state):
    """Round-trip the gradients through int8 error-feedback quantization:
    (what crosses the wire, decompressed; the new error state). One leaf
    at a time, so one leaf's float32 temporaries are live at once."""
    out, errs = {}, {}
    for n, g in grads.items():
        q, scale, errs[n] = compress(g, ef_state[n])
        out[n] = decompress(q, scale)
    return out, errs
