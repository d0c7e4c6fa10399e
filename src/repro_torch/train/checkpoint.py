"""Checkpoints in the JAX package's format: atomic, manifest-based.

The counterpart of the JAX package's ``train/checkpoint.py``, writing the
same files: ``step-XXXXXXXX.npz`` holds the state's leaves as arrays
``a0, a1, ...`` in the reference's leaf order, and ``step-XXXXXXXX.json``
its manifest (step, keys, shapes, dtypes) with the reference's keys
(``0/embed``, ``1/.mu/layers/wq``, ...). bfloat16 is stored as float32,
a lossless superset, and cast back bit for bit. Writes go to a
temporary file and an atomic rename, so a failure mid-write never
corrupts the latest checkpoint; a checkpoint written by either package
restores in the other.

The state is a tree of dicts (sorted by key, as JAX orders them),
tuples, lists, NamedTuples (``AdamWState``: keys ``.step``, ``.mu``,
``.nu``) and leaves (tensors, numpy arrays, numbers). Two of the port's
forms are written as the reference's parameter tree
(``{"embed", "final_norm", "layers": {name: (L, ...)}, "unembed"}``),
each layer's weights stacked: an ``LM``, and a dict keyed by its
parameter names (``layers.<i>.<name>``: gradients, optimizer
moments). A ``MIND`` is written as the reference's flat tree
(``table``, ``bilinear``, ``route_init``, ``out_proj``); its moments are
plain dicts with those keys already. ``restore`` gives back the same
forms, on ``device`` (default: where each target leaf lies).
"""
from __future__ import annotations

import json
import os
import re
import threading

import numpy as np
import torch

from ..models import recsys
from ..models import transformer as tf


class _Layers:
    """The per-layer tensors of one weight: one leaf, (L, ...) on disk."""

    def __init__(self, parts: list):
        self.parts = parts
        self.shape = (len(parts),) + tuple(parts[0].shape)
        self.dtype = parts[0].dtype


def _is_named(tree) -> bool:
    return isinstance(tree, dict) and any(
        isinstance(k, str) and k.startswith("layers.") for k in tree)


def _walk(tree, path: tuple, leaf_fn, rebuild: bool = True):
    """``tree`` rebuilt in the reference's leaf order, each leaf replaced
    by ``leaf_fn(key, leaf)``; with ``rebuild`` False, the leaves are
    only visited in that order."""
    if isinstance(tree, tf.LM):
        new = _walk(dict(tree.named_parameters()), path, leaf_fn, rebuild)
        if not rebuild:
            return None
        layers = [{w: new[f"layers.{i}.{w}"]
                   for w in tf.layer_weights(tree.cfg)}
                  for i in range(tree.cfg.n_layers)]
        return tf.LM(tree.cfg, new["embed"], new["unembed"],
                     new["final_norm"], layers)
    if isinstance(tree, recsys.MIND):
        new = _walk(dict(tree.named_parameters()), path, leaf_fn, rebuild)
        if not rebuild:
            return None
        return recsys.MIND(tree.cfg, *(new[n] for n in recsys.PARAM_NAMES))
    if _is_named(tree):
        new = _walk(tf.param_tree(tree, stack=_Layers), path, leaf_fn,
                    rebuild)
        if not rebuild:
            return None
        out = tf.named_from_tree(new)
        return {name: out[name] for name in tree}
    if isinstance(tree, dict):
        return {k: _walk(tree[k], path + (str(k),), leaf_fn, rebuild)
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(getattr(tree, f), path + (f".{f}",),
                                  leaf_fn, rebuild) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, path + (str(i),), leaf_fn, rebuild)
                          for i, v in enumerate(tree))
    return leaf_fn("/".join(path), tree)


def _leaves(tree) -> tuple[list[str], list]:
    keys, vals = [], []

    def record(key, leaf):
        keys.append(key)
        vals.append(leaf)
        return leaf
    _walk(tree, (), record, rebuild=False)
    return keys, vals


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array that is written (bfloat16 as float32)."""
    if isinstance(leaf, _Layers):
        return np.stack([_host(p) for p in leaf.parts])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    a = np.asarray(leaf)
    if a.dtype.kind == "V" or "bfloat16" in str(a.dtype):
        a = a.astype(np.float32)
    return a


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         blocking: bool = True) -> str:
    """Write ``tree`` as step ``step``'s checkpoint, then keep only the
    last ``keep``; ``blocking=False`` writes from a thread (the arrays
    are on the host before it starts)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    keys, vals = _leaves(tree)
    arrays = {f"a{i}": _host(v) for i, v in enumerate(vals)}

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp-{step}.npz")
        final = os.path.join(ckpt_dir, f"step-{step:08d}.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, final)                       # atomic
        manifest = {"step": step, "keys": keys,
                    "shapes": [list(a.shape) for a in arrays.values()],
                    "dtypes": [str(a.dtype) for a in arrays.values()]}
        mtmp = os.path.join(ckpt_dir, ".tmp-manifest.json")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(ckpt_dir, f"step-{step:08d}.json"))
        _gc(ckpt_dir, keep)

    if blocking:
        _write()
    else:
        threading.Thread(target=_write, daemon=True).start()
    return os.path.join(ckpt_dir, f"step-{step:08d}.npz")


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        for ext in ("npz", "json"):
            try:
                os.remove(os.path.join(ckpt_dir, f"step-{s:08d}.{ext}"))
            except FileNotFoundError:
                pass


def all_steps(ckpt_dir: str) -> list[int]:
    """The steps with both an array file and a manifest, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step-(\d+)\.npz", f)
        if m and os.path.exists(os.path.join(
                ckpt_dir, f"step-{m.group(1)}.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _dtype(leaf):
    """The torch dtype a restored leaf takes: the target's."""
    if isinstance(leaf, (torch.Tensor, _Layers)):
        return leaf.dtype
    a = np.asarray(leaf)
    if "bfloat16" in str(a.dtype):
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), a.dtype)).dtype


def _device(leaf, device):
    if device is not None:
        return torch.device(device)
    if isinstance(leaf, torch.Tensor):
        return leaf.device
    if isinstance(leaf, _Layers):
        return _device(leaf.parts[0], None)
    return torch.device("cpu")


def restore(ckpt_dir: str, target_tree, *, step: int | None = None,
            device=None):
    """(tree, step): the checkpoint of ``step`` (default the latest) in
    the structure, forms and dtypes of ``target_tree``, each leaf on
    ``device`` or, when it is None, on its target's device. A shape that
    differs from the target's raises ``ValueError``."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    z = np.load(os.path.join(ckpt_dir, f"step-{step:08d}.npz"))
    keys, vals = _leaves(target_tree)
    loaded = {}
    for i, (k, v) in enumerate(zip(keys, vals)):
        a = z[f"a{i}"]
        want = tuple(v.shape) if hasattr(v, "shape") else np.shape(v)
        if tuple(a.shape) != tuple(want):
            raise ValueError(f"shape mismatch for {k}: {a.shape} vs "
                             f"{tuple(want)}")
        loaded[k] = a

    def put(key, leaf):
        a, dt, dev = loaded[key], _dtype(leaf), _device(leaf, device)
        if isinstance(leaf, _Layers):
            return [torch.from_numpy(np.ascontiguousarray(row)).to(
                device=dev, dtype=dt) for row in a]
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev,
                                                            dtype=dt)
    return _walk(target_tree, (), put), step
