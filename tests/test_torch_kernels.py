"""Kernel B1, the PCPM gather: the port's wrapper against the JAX
package's Pallas kernel, run in interpret mode as tests/test_kernels.py
runs it, at the shapes and tolerances of its ``TestPCPMKernel``.

On CPU tensors the wrapper computes the plain version; the CUDA kernel
itself is tested in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro_torch.core import Partitioning, block_png, build_png
from repro_torch.graphs import generators
from repro_torch.kernels.pcpm_spmv import (kernel, pack_blocked,
                                           pcpm_gather_cuda, pcpm_spmv_pallas)

from test_torch_reference import dense_spmv, load_reference

ref_gen = load_reference("graphs.generators")
ref_core = load_reference("core")
ref_b1 = load_reference("kernels.pcpm_spmv")

SHAPES = [(6, 4, 16, 1), (7, 8, 32, 8), (8, 6, 64, 16), (7, 4, 128, 32)]
EDGE_BLOCK = 128


def _layouts(scale, deg, part_size):
    g = generators.rmat(scale, deg, seed=scale)
    r = ref_gen.rmat(scale, deg, seed=scale)
    blk = block_png(build_png(g, Partitioning(g.num_nodes, part_size)))
    ref_blk = ref_core.block_png(ref_core.build_png(
        r, ref_core.Partitioning(r.num_nodes, part_size)))
    return g, blk, ref_blk


def _x(n, d, seed):
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


def _direct_inputs(seed):
    # random, unsorted streams with pads, as TestPCPMKernel draws them
    rng = np.random.default_rng(seed)
    k, U, d, P, Eb, neb = 4, 128, 128, 64, 128, 3
    bins = rng.random((k, U, d)).astype(np.float32)
    eu = rng.integers(0, U + 1, (k, neb, Eb)).astype(np.int32)
    ed = rng.integers(0, P + 1, (k, neb, Eb)).astype(np.int32)
    return bins, eu, ed, P


@pytest.mark.parametrize("scale,deg,part_size,d", SHAPES)
def test_spmv_matches_dense_and_pallas(scale, deg, part_size, d):
    g, blk, ref_blk = _layouts(scale, deg, part_size)
    x = _x(g.num_nodes, d, seed=scale)
    xin = x[:, 0] if d == 1 else x
    packed = pack_blocked(blk, g.num_nodes, edge_block=EDGE_BLOCK,
                          device="cpu")
    y = pcpm_spmv_pallas(packed, torch.from_numpy(np.ascontiguousarray(xin)))
    assert y.shape == xin.shape
    dense = dense_spmv(g.num_nodes, g.src, g.dst, x)
    np.testing.assert_allclose(y.numpy().reshape(dense.shape), dense,
                               rtol=1e-4, atol=1e-5)
    ref_packed = ref_b1.pack_blocked(ref_blk, g.num_nodes,
                                     edge_block=EDGE_BLOCK)
    y_ref = ref_b1.pcpm_spmv_pallas(ref_packed, jnp.asarray(xin),
                                    interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("scale,deg,part_size,d", SHAPES)
def test_gather_matches_pallas_interpret(scale, deg, part_size, d):
    g, blk, ref_blk = _layouts(scale, deg, part_size)
    packed = pack_blocked(blk, g.num_nodes, edge_block=EDGE_BLOCK,
                          device="cpu")
    x = _x(g.num_nodes, d, seed=scale + 1)
    upd, valid = packed.update_src.numpy(), packed.update_valid.numpy()
    bins = x[upd] * valid[..., None]
    out = pcpm_gather_cuda(torch.from_numpy(bins), packed.edge_upd,
                           packed.edge_dst, part_size=part_size)
    out_ref = ref_b1.pcpm_gather_pallas(
        jnp.asarray(bins), jnp.asarray(packed.edge_upd.numpy()),
        jnp.asarray(packed.edge_dst.numpy()), part_size=part_size,
        interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("scale,deg,part_size", [s[:3] for s in SHAPES])
def test_edges_read_only_valid_updates(scale, deg, part_size):
    # pcpm_spmv_pallas leaves out the JAX version's `bins * update_valid`:
    # that is exact only while no edge reads a pad update slot
    g, blk, _ = _layouts(scale, deg, part_size)
    packed = pack_blocked(blk, g.num_nodes, edge_block=EDGE_BLOCK,
                          device="cpu")
    k, u = packed.update_src.shape
    eu = packed.edge_upd.reshape(k, -1).numpy()
    ed = packed.edge_dst.reshape(k, -1).numpy()
    read = eu < u
    rows = np.broadcast_to(np.arange(k)[:, None], eu.shape)
    assert packed.update_valid.numpy()[rows[read], eu[read]].all()
    assert np.array_equal(read, ed < part_size)
    assert int(read.sum()) == g.num_edges


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_vs_pallas_direct(dtype):
    bins, eu, ed, P = _direct_inputs(seed=42)
    tdt = getattr(torch, dtype)
    out = pcpm_gather_cuda(torch.from_numpy(bins).to(tdt),
                           torch.from_numpy(eu), torch.from_numpy(ed),
                           part_size=P)
    assert out.dtype == tdt and out.shape == (bins.shape[0], P,
                                              bins.shape[2])
    out_ref = ref_b1.pcpm_gather_pallas(
        jnp.asarray(bins, dtype=getattr(jnp, dtype)), jnp.asarray(eu),
        jnp.asarray(ed), part_size=P, interpret=True)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(out_ref, np.float32), rtol=tol,
                               atol=tol)


def test_empty_partition():
    # a partition with zero edges must produce zeros
    k, U, d, P, Eb = 2, 128, 128, 8, 128
    bins = torch.from_numpy(
        np.random.default_rng(1).random((k, U, d)).astype(np.float32))
    eu = torch.full((k, 1, Eb), U, dtype=torch.int32)   # all padding
    ed = torch.full((k, 1, Eb), P, dtype=torch.int32)
    out = pcpm_gather_cuda(bins, eu, ed, part_size=P)
    assert torch.count_nonzero(out) == 0
    out_ref = ref_b1.pcpm_gather_pallas(jnp.asarray(bins.numpy()),
                                        jnp.asarray(eu.numpy()),
                                        jnp.asarray(ed.numpy()),
                                        part_size=P, interpret=True)
    assert np.allclose(np.asarray(out_ref), 0.0)


def test_cpu_calls_do_not_count_as_launches():
    bins, eu, ed, P = _direct_inputs(seed=3)
    before = kernel.launch_count
    pcpm_gather_cuda(torch.from_numpy(bins), torch.from_numpy(eu),
                     torch.from_numpy(ed), part_size=P)
    assert kernel.launch_count == before


@pytest.mark.parametrize("bad", ["bins_dtype", "idx_dtype", "shape",
                                 "partitions", "part_size"])
def test_wrapper_rejects(bad):
    bins, eu, ed, P = map(lambda a: torch.from_numpy(a)
                          if isinstance(a, np.ndarray) else a,
                          _direct_inputs(seed=4))
    if bad == "bins_dtype":
        bins = bins.double()
    elif bad == "idx_dtype":
        eu = eu.long()
    elif bad == "shape":
        ed = ed[:, :2]
    elif bad == "partitions":
        bins = bins[:2]
    else:
        P = 0
    with pytest.raises((TypeError, ValueError)):
        pcpm_gather_cuda(bins, eu, ed, part_size=P)
