"""The JAX reference as the port's tests load it, and checks of the loader.

``load_reference()`` registers ``src/repro`` under the alias package
``repro_ref``: a bare module whose ``__path__`` is that directory, so
``repro/__init__.py`` (which imports every subsystem eagerly) never runs
and ``repro`` itself never enters ``sys.modules``. The reference has no
absolute ``repro.`` imports, so each subpackage imports as
``repro_ref.<name>``. Every ``tests/test_torch_*.py`` file gets the
reference from here and never imports ``repro``.
"""
from __future__ import annotations

import importlib
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
REF_ALIAS = "repro_ref"


def load_reference(name: str = ""):
    """``repro_ref`` (or its submodule ``repro_ref.<name>``)."""
    pkg = sys.modules.get(REF_ALIAS)
    if pkg is None:
        pkg = types.ModuleType(REF_ALIAS)
        pkg.__path__ = [str(REPO / "src" / "repro")]
        pkg.__package__ = REF_ALIAS
        sys.modules[REF_ALIAS] = pkg
    return importlib.import_module(f"{REF_ALIAS}.{name}") if name else pkg


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips when there is none.
    Decided here, at run time, never while a module is imported."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def dense_spmv(num_nodes: int, src: np.ndarray, dst: np.ndarray,
               x: np.ndarray) -> np.ndarray:
    """Dense float64 ``A.T @ x`` — the oracle of small-graph checks."""
    a = np.zeros((num_nodes, num_nodes))
    np.add.at(a, (src, dst), 1.0)
    return a.T @ x


def hand_schedule(part: np.ndarray, upd: np.ndarray, dst: np.ndarray, *,
                  part_size: int, num_partitions: int, tile: int,
                  chunk_edges: int, blocks: int, device="cpu"):
    """A ``TileSchedule`` of kernel B1 over given flat streams (``part``,
    the partition of each edge, non-decreasing), not in the port's
    order: each partition's edges cut into chunks of ``chunk_edges``,
    each chunk given the tile of its first edge's destination (so its
    other edges may lie outside it), the chunks dealt to ``blocks``
    blocks in contiguous runs."""
    import torch
    from repro_torch.kernels.pcpm_spmv import TileSchedule, ops
    bounds = np.searchsorted(part, np.arange(num_partitions + 1))
    rows = [(p, min(int(dst[a]), part_size - 1) // tile, a,
             min(a + chunk_edges, bounds[p + 1]))
            for p in range(num_partitions)
            for a in range(bounds[p], bounds[p + 1], chunk_edges)]
    chunks = np.array(rows, dtype=np.int32).reshape(-1, 4)
    block_chunks = np.arange(blocks + 1) * len(chunks) // blocks
    # hubs from the edges that lie in their chunk's tile
    n_tiles = -(-part_size // tile)
    seg = np.concatenate([np.full(b - a, p * n_tiles + t)
                          for p, t, a, b in rows] or [np.zeros(0, int)])
    jt = dst - seg % n_tiles * tile
    inside = (jt >= 0) & (jt < tile)
    hubs = ops.tile_hubs(seg[inside], jt[inside], num_partitions * n_tiles,
                         tile)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return TileSchedule(part_size, num_partitions, tile, up(upd), up(dst),
                        up(chunks), up(block_chunks), up(hubs))


def test_alias_leaves_repro_unimported():
    # in a fresh interpreter: other test files in this worker may have
    # imported ``repro`` themselves
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_reference as t; "
            "t.load_reference('core'); t.load_reference('kernels.pcpm_spmv'); "
            "bad = [m for m in sys.modules if m.split('.')[0] == 'repro']; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code, str(REPO / "tests")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("method", ["pdpr", "bvgas", "pcpm"])
def test_reference_runs_through_alias(method):
    gen = load_reference("graphs.generators")
    core = load_reference("core")
    g = gen.rmat(8, 4, seed=3)
    res = core.pagerank(g, method=method, part_size=64)
    ref = core.pagerank_reference(g)
    np.testing.assert_allclose(np.asarray(res.ranks), ref, atol=1e-6)
