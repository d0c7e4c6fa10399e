"""The port on the card: kernel B1 against its plain version, and the
main path ``open(g, device="cuda").pagerank()`` against the same solve
on the CPU and the dense oracle.

Every test is marked ``cuda`` and skips without a card. The file needs
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch for CUDA:  ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import (Partitioning, block_png, build_png,
                              pagerank_reference)
from repro_torch.graphs import generators
from repro_torch.kernels.pcpm_spmv import (kernel, pack_blocked,
                                           pcpm_gather_cuda, pcpm_gather_ref,
                                           pcpm_spmv_pallas)

from test_torch_reference import cuda_device, dense_spmv  # noqa: F401

pytestmark = pytest.mark.cuda

SHAPES = [(6, 4, 16, 1), (7, 8, 32, 8), (8, 6, 64, 16), (7, 4, 128, 32)]
METHODS = ["pdpr", "bvgas", "pcpm", "pcpm_pallas"]


def _unsorted_inputs(dev, dtype, seed):
    rng = np.random.default_rng(seed)
    k, U, d, P, Eb, neb = 4, 128, 128, 64, 128, 3
    bins = torch.from_numpy(rng.random((k, U, d))).to(dev, dtype)
    eu = torch.from_numpy(rng.integers(0, U + 1, (k, neb, Eb)).astype(
        np.int32)).to(dev)
    ed = torch.from_numpy(rng.integers(0, P + 1, (k, neb, Eb)).astype(
        np.int32)).to(dev)
    return bins, eu, ed, P


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_vs_plain_unsorted(cuda_device, dtype):
    bins, eu, ed, P = _unsorted_inputs(cuda_device, getattr(torch, dtype), 7)
    before = kernel.launch_count
    out = pcpm_gather_cuda(bins, eu, ed, part_size=P)
    torch.cuda.synchronize()
    assert kernel.launch_count == before + 1
    assert out.dtype == bins.dtype
    tol = 1e-5 if dtype == "float32" else 5e-2
    torch.testing.assert_close(
        out.float(), pcpm_gather_ref(bins, eu, ed, part_size=P).float(),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("scale,deg,part_size,d", SHAPES)
def test_spmv_matches_dense(cuda_device, scale, deg, part_size, d):
    g = generators.rmat(scale, deg, seed=scale)
    packed = pack_blocked(block_png(build_png(
        g, Partitioning(g.num_nodes, part_size))), g.num_nodes,
        edge_block=128, device=cuda_device)
    x = np.random.default_rng(scale).random((g.num_nodes, d)).astype(
        np.float32)
    y = pcpm_spmv_pallas(packed, torch.from_numpy(x).to(cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.cpu().numpy(),
                               dense_spmv(g.num_nodes, g.src, g.dst, x),
                               rtol=1e-4, atol=1e-5)


def test_empty_partition(cuda_device):
    k, U, d, P, Eb = 2, 128, 128, 8, 128
    bins = torch.rand((k, U, d), device=cuda_device)
    eu = torch.full((k, 1, Eb), U, dtype=torch.int32, device=cuda_device)
    ed = torch.full((k, 1, Eb), P, dtype=torch.int32, device=cuda_device)
    out = pcpm_gather_cuda(bins, eu, ed, part_size=P)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out) == 0


def test_wrapper_rejects_non_contiguous(cuda_device):
    bins, eu, ed, P = _unsorted_inputs(cuda_device, torch.float32, 8)
    with pytest.raises(ValueError, match="contiguous"):
        pcpm_gather_cuda(bins.transpose(1, 2).contiguous().transpose(1, 2),
                         eu, ed, part_size=P)


@pytest.mark.parametrize("method", METHODS)
def test_open_pagerank_on_the_card(cuda_device, method):
    g = generators.rmat(10, 8, seed=0)
    cfg = repro_torch.EngineConfig(method=method, part_size=256,
                                   num_iterations=100, tol=1e-6,
                                   check_every=3)
    before = kernel.launch_count
    sess = repro_torch.open(g, cfg)               # cuda is the default
    assert sess.device.type == "cuda"
    res = sess.pagerank()
    torch.cuda.synchronize()
    launches = kernel.launch_count - before
    assert launches == (res.iterations if method == "pcpm_pallas" else 0)
    cpu = repro_torch.open(g, cfg, device="cpu").pagerank()
    assert res.iterations == cpu.iterations < 100
    assert len(res.residuals) == len(cpu.residuals)
    ranks = res.ranks.cpu().numpy()
    assert np.abs(ranks - cpu.ranks.numpy()).max() <= 1e-6
    oracle = pagerank_reference(g, num_iterations=res.iterations)
    assert np.abs(ranks - oracle).max() <= 1e-6
    ids, _ = sess.top_ranked(10)
    np.testing.assert_array_equal(ids, np.lexsort(
        (np.arange(g.num_nodes), -oracle))[:10])
