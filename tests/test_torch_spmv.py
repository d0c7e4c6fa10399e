"""Port vs reference: the SpMV engines as torch ops on CPU tensors.

Both sides get the same streams and the same x, made with numpy from a
seed. The torch ops sum in another order than XLA, so float32 results
agree to rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro_torch.core import (Partitioning, SpMVEngine, build_gather_schedule,
                              build_png, bvgas_gather, bvgas_scatter,
                              pcpm_gather, pcpm_gather_blocked, pcpm_spmv,
                              pcpm_spmv_weighted, pdpr_spmv)
from repro_torch.graphs import generators

from test_torch_reference import dense_spmv, load_reference

ref_gen = load_reference("graphs.generators")
ref_core = load_reference("core")

RTOL, ATOL = 1e-5, 1e-6
WIDTHS = [None, 8]          # x of shape (n,) and (n, 8)


def _x(n, width, seed=0):
    shape = (n,) if width is None else (n, width)
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _x_dyadic(n, width, seed=0):
    """Multiples of 1/64 below 1: every partial sum of a few thousand of
    them is exact in float32, so any summation order gives the same bits.
    The blocked gather subtracts block-local prefix sums, whose rounding
    error grows with the prefix (up to block * max x) and depends on the
    order XLA's and torch's cumsum add in; exact inputs make the
    comparison check the indexing, not the order."""
    shape = (n,) if width is None else (n, width)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, shape) / 64).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def graph():
    g = generators.rmat(9, 8, seed=2)
    png = build_png(g, Partitioning(g.num_nodes, 64))
    return g, png


@pytest.mark.parametrize("width", WIDTHS)
def test_pdpr(graph, width):
    g, _ = graph
    order = np.lexsort((g.src, g.dst))
    src, dst = g.src[order], g.dst[order]
    x = _x(g.num_nodes, width)
    y = pdpr_spmv(_t(src), _t(dst), _t(x), num_nodes=g.num_nodes)
    _close(y, ref_core.pdpr_spmv(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(x), num_nodes=g.num_nodes))
    np.testing.assert_allclose(y.numpy(),
                               dense_spmv(g.num_nodes, g.src, g.dst, x),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("width", WIDTHS)
def test_bvgas_phases(graph, width):
    g, _ = graph
    x = _x(g.num_nodes, width, seed=1)
    bins = bvgas_scatter(_t(g.src), _t(x))
    ref_bins = ref_core.bvgas_scatter(jnp.asarray(g.src), jnp.asarray(x))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(ref_bins))
    _close(bvgas_gather(bins, _t(g.dst), num_nodes=g.num_nodes),
           ref_core.bvgas_gather(ref_bins, jnp.asarray(g.dst),
                                 num_nodes=g.num_nodes))


@pytest.mark.parametrize("width", WIDTHS)
def test_pcpm_flat(graph, width):
    g, png = graph
    x = _x(g.num_nodes, width, seed=2)
    args = (png.update_src, png.edge_update_idx, png.edge_dst)
    y = pcpm_spmv(*map(_t, args), _t(x), num_nodes=g.num_nodes)
    _close(y, ref_core.pcpm_spmv(*map(jnp.asarray, args), jnp.asarray(x),
                                 num_nodes=g.num_nodes))
    bins = np.asarray(x)[png.update_src]
    _close(pcpm_gather(_t(bins), _t(png.edge_update_idx), _t(png.edge_dst),
                       num_nodes=g.num_nodes),
           ref_core.pcpm_gather(jnp.asarray(bins),
                                jnp.asarray(png.edge_update_idx),
                                jnp.asarray(png.edge_dst),
                                num_nodes=g.num_nodes))


@pytest.mark.parametrize("block,make_x", [(16, _x), (16, _x_dyadic),
                                          (256, _x_dyadic)])
@pytest.mark.parametrize("width", WIDTHS)
def test_pcpm_gather_blocked(graph, width, block, make_x):
    g, png = graph
    s = build_gather_schedule(png, block=block)
    x = make_x(g.num_nodes, width, seed=3)
    bins = np.asarray(x)[png.update_src]
    args = (bins, s.edge_update_idx_padded, s.piece_start, s.piece_end,
            s.piece_dst)
    y = pcpm_gather_blocked(*map(_t, args), num_nodes=g.num_nodes,
                            block=block)
    _close(y, ref_core.pcpm_gather_blocked(*map(jnp.asarray, args),
                                           num_nodes=g.num_nodes,
                                           block=block))


@pytest.mark.parametrize("width", WIDTHS)
def test_pcpm_spmv_weighted(graph, width):
    g, png = graph
    x = _x(g.num_nodes, width, seed=4)
    w = np.random.default_rng(9).random(g.num_edges).astype(np.float32)
    args = (png.update_src, png.edge_update_idx, png.edge_dst, w, x)
    _close(pcpm_spmv_weighted(*map(_t, args), num_nodes=g.num_nodes),
           ref_core.pcpm_spmv_weighted(*map(jnp.asarray, args),
                                       num_nodes=g.num_nodes))


@pytest.mark.parametrize("reorder", ["none", "degree"])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("method", ["pdpr", "bvgas", "pcpm", "pcpm_pallas"])
def test_engine_matches_reference_engine(method, width, reorder):
    from repro_torch.core import PlanConfig, build_plan
    g, r = generators.rmat(8, 6, seed=4), ref_gen.rmat(8, 6, seed=4)
    x = _x_dyadic(g.num_nodes, width, seed=5)
    plan = build_plan(g, PlanConfig(method=method, part_size=64,
                                    reorder=reorder))
    y = SpMVEngine(g, plan=plan, device="cpu")(_t(x))
    ref_plan = ref_core.build_plan(r, ref_core.PlanConfig(
        method=method, part_size=64, reorder=reorder))
    _close(y, ref_core.SpMVEngine(r, plan=ref_plan)(jnp.asarray(x)))


@pytest.mark.parametrize("method", ["bvgas", "pcpm"])
def test_two_phase_engine(method):
    g = generators.rmat(8, 6, seed=4)
    x = _x(g.num_nodes, None, seed=6)
    y2 = SpMVEngine(g, method=method, part_size=64, two_phase=True,
                    device="cpu")(_t(x))
    y1 = SpMVEngine(g, method=method, part_size=64, device="cpu")(_t(x))
    torch.testing.assert_close(y2, y1, rtol=0, atol=0)
    with pytest.raises(ValueError, match="two_phase"):
        SpMVEngine(g, method="pdpr", part_size=64, two_phase=True,
                   device="cpu")
