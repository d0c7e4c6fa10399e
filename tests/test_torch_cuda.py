"""The port on the card: kernel B1 against its plain version through
both of its paths ("warp", "tile"), and the
main path ``open(g, device="cuda").pagerank()`` against the same solve
on the CPU and the dense oracle; PageRank serving (``SlotScheduler``,
``PageRankServer``, device push) with B1's launches counted per path;
streaming deltas (patched plans of each method against the CPU, B1 on a
patched plan against its plain version, ``Session.apply_delta`` with a
warm update and ``SlotScheduler.apply_delta`` with launches counted by
path); kernel B3 against its plain version
through each of its paths ("tc", "simt", "split"), and the smoke LM's
``ServeEngine`` on the card against the same run on the CPU; kernel B2
against its plain version, and the smoke MIND's
``serve_step``/``retrieval_step`` on the card against the CPU.

Every test is marked ``cuda`` and skips without a card. The file needs
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch for CUDA:  ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import copy

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.core import (Partitioning, block_png, build_png,
                              pagerank_reference)
from repro_torch.graphs import generators
from repro_torch.core.png import BlockedPNG
from repro_torch.kernels.pcpm_spmv import (kernel, ops, pack_blocked,
                                           pcpm_gather_cuda, pcpm_gather_ref,
                                           pcpm_spmv_cuda, pcpm_spmv_pallas,
                                           pcpm_spmv_ref, tile_schedule)
from repro_torch.kernels import embedding_bag as b2
from repro_torch.kernels import flash_attention as b3
from repro_torch.models import recsys
from repro_torch.models import transformer as tf
from repro_torch.serve import Request, ServeEngine

from test_torch_reference import (cuda_device, dense_spmv,  # noqa: F401
                                  hand_schedule)

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


# ----------------------------------------------- kernel B1, path "tile"
def _tile_inputs(dev, scale, deg, part_size, seed):
    """A rmat layout packed on the card and bins that are multiples of
    1/16, whose sums are exact in any order."""
    g = generators.rmat(scale, deg, seed=scale)
    blk = block_png(build_png(g, Partitioning(g.num_nodes, part_size)))
    packed = pack_blocked(blk, g.num_nodes, edge_block=128, device=dev)
    x = np.random.default_rng(seed).integers(0, 16, g.num_nodes) / 16
    k, u = packed.update_src.shape
    bins = torch.from_numpy(x.astype(np.float32)).to(dev)[
        packed.update_src.view(-1)].view(k, u, 1)
    return g, blk, packed, bins


def _tile_call(bins, packed, schedule):
    before = dict(kernel.launch_counts)
    out = pcpm_gather_cuda(bins, packed.edge_upd, packed.edge_dst,
                           part_size=packed.part_size, schedule=schedule)
    torch.cuda.synchronize()
    assert kernel.launch_counts["tile"] == before["tile"] + 1
    assert kernel.launch_counts["warp"] == before["warp"]
    return out


@pytest.mark.parametrize("tile_bytes", [64, ops.TILE_BYTES])
@pytest.mark.parametrize("scale,deg,part_size", [s[:3] for s in SHAPES])
def test_b1_tile_vs_plain(cuda_device, scale, deg, part_size, tile_bytes):
    _, blk, packed, bins = _tile_inputs(cuda_device, scale, deg, part_size,
                                        seed=scale)
    schedule = tile_schedule(blk, tile_bytes=tile_bytes, device=cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        b = bins.to(dtype)
        out = _tile_call(b, packed, schedule)
        ref = pcpm_gather_ref(b, packed.edge_upd, packed.edge_dst,
                              part_size=part_size)
        assert out.dtype == dtype and torch.equal(out, ref)


def test_b1_tile_all_pad_partition(cuda_device):
    # partition 0 has no edge at all: no chunk, zeros
    k, u_slots, part_size = 2, 4, 8
    eu = np.full((k, 6), u_slots, dtype=np.int32)
    ed = np.full((k, 6), part_size, dtype=np.int32)
    eu[1, :3], ed[1, :3] = [0, 1, 1], [7, 2, 5]
    blk = BlockedPNG(part_size, np.arange(k * u_slots, dtype=np.int32)
                     .reshape(k, u_slots), eu, ed, 0.0, 0.0)
    packed = pack_blocked(blk, k * part_size, edge_block=128,
                          device=cuda_device)
    schedule = tile_schedule(blk, tile_bytes=16, device=cuda_device)
    bins = torch.rand((k, u_slots, 1), device=cuda_device)
    out = _tile_call(bins, packed, schedule)
    assert torch.count_nonzero(out[0]) == 0
    torch.testing.assert_close(out, pcpm_gather_ref(
        bins, packed.edge_upd, packed.edge_dst, part_size=part_size),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("order", ["dst-sorted", "random"])
def test_b1_tile_edges_outside_their_chunks_tile(cuda_device, order):
    _, blk, packed, bins = _tile_inputs(cuda_device, 8, 6, 64, seed=1)
    k, u = packed.update_src.shape
    eu = packed.edge_upd.reshape(k, -1).cpu().numpy()
    ed = packed.edge_dst.reshape(k, -1).cpu().numpy()
    rng = np.random.default_rng(0)
    parts, ups, dsts = [], [], []
    for p in range(k):
        real = np.flatnonzero((eu[p] < u) & (ed[p] < packed.part_size))
        if order == "random":
            real = rng.permutation(real)
        parts.append(np.full(len(real), p))
        ups.append(eu[p][real])
        dsts.append(ed[p][real])
    schedule = hand_schedule(np.concatenate(parts), np.concatenate(ups),
                             np.concatenate(dsts),
                             part_size=packed.part_size, num_partitions=k,
                             tile=16, chunk_edges=37, blocks=5,
                             device=cuda_device)
    out = _tile_call(bins, packed, schedule)
    assert torch.equal(out, pcpm_gather_ref(
        bins, packed.edge_upd, packed.edge_dst, part_size=packed.part_size))


def test_pcpm_pallas_solves_through_the_tile_path(cuda_device):
    g = generators.rmat(10, 8, seed=0)
    cfg = repro_torch.EngineConfig(method="pcpm_pallas", part_size=256,
                                   num_iterations=12)
    before = dict(kernel.launch_counts)
    res = repro_torch.open(g, cfg).pagerank()
    torch.cuda.synchronize()
    assert kernel.launch_counts["tile"] - before["tile"] == res.iterations
    assert kernel.launch_counts["warp"] == before["warp"]
    oracle = pagerank_reference(g, num_iterations=res.iterations)
    assert np.abs(res.ranks.cpu().numpy() - oracle).max() <= 1e-6


# ----------------------------------------------- kernel B1, path "warp"
def _warp_call(fn, *args, **kw):
    """One call of a "warp" entry point: exactly one "warp" launch."""
    before = dict(kernel.launch_counts)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launch_counts["warp"] == before["warp"] + 1
    assert kernel.launch_counts["tile"] == before["tile"]
    return out


def _warp_both_forms(x, packed, eu=None, ed=None):
    """B1 "warp" from bins and in the fused form, each with its plain
    version, on the same x (n, d)."""
    eu = packed.edge_upd if eu is None else eu
    ed = packed.edge_dst if ed is None else ed
    k, u = packed.update_src.shape
    bins = x[packed.update_src.view(-1)].view(k, u, x.shape[1])
    p = packed.part_size
    return {
        "bins": (_warp_call(pcpm_gather_cuda, bins, eu, ed, part_size=p),
                 pcpm_gather_ref(bins, eu, ed, part_size=p)),
        "fused": (_warp_call(pcpm_spmv_cuda, x, packed.update_src, eu, ed,
                             part_size=p),
                  pcpm_spmv_ref(x, packed.update_src, eu, ed, part_size=p)),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [None, 1, 3, 16, 17, 33])
@pytest.mark.parametrize("scale,deg,part_size,d0", SHAPES)
def test_b1_warp_both_forms_vs_plain(cuda_device, scale, deg, part_size, d0,
                                     d, dtype):
    """The TestPCPMKernel rmat layouts at their own d (None) and at other
    widths, among them ones that are no multiple of a 16-byte slice:
    float32 within 1e-5 (atomics add in a run-dependent order), bfloat16
    within 5e-2 (one rounding of the output apart)."""
    d = d0 if d is None else d
    g = generators.rmat(scale, deg, seed=scale)
    packed = pack_blocked(block_png(build_png(
        g, Partitioning(g.num_nodes, part_size))), g.num_nodes,
        edge_block=128, device=cuda_device)
    x = torch.from_numpy(np.random.default_rng(d).random(
        (g.num_nodes, d)).astype(np.float32)).to(cuda_device,
                                                 getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 5e-2
    for form, (out, ref) in _warp_both_forms(x, packed).items():
        assert out.dtype == x.dtype and out.shape == ref.shape, form
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"{form}: {m}")


@pytest.mark.parametrize("order", ["shuffled", "reversed"])
@pytest.mark.parametrize("d", [1, 16, 17])
def test_b1_warp_unsorted_streams_exact(cuda_device, order, d):
    """Each partition's slots shuffled or reversed (pads among the edges):
    on rows that are multiples of 1/16 every summation order gives the
    same bits, so both forms equal the plain version exactly."""
    g = generators.rmat(9, 8, seed=3)
    packed = pack_blocked(block_png(build_png(
        g, Partitioning(g.num_nodes, 64))), g.num_nodes, edge_block=128,
        device=cuda_device)
    k = packed.num_partitions
    eu = packed.edge_upd.reshape(k, -1).clone()
    ed = packed.edge_dst.reshape(k, -1).clone()
    gen = torch.Generator(device="cpu").manual_seed(d)
    for p in range(k):
        perm = (torch.randperm(eu.shape[1], generator=gen)
                if order == "shuffled"
                else torch.arange(eu.shape[1] - 1, -1, -1)).to(cuda_device)
        eu[p], ed[p] = eu[p][perm], ed[p][perm]
    eu, ed = eu.view_as(packed.edge_upd), ed.view_as(packed.edge_dst)
    x = (torch.randint(0, 16, (g.num_nodes, d), generator=gen).float()
         / 16).to(cuda_device)
    for form, (out, ref) in _warp_both_forms(x, packed, eu, ed).items():
        assert torch.equal(out, ref), form


@pytest.mark.parametrize("d", [1, 16])
def test_b1_warp_all_pad_partition(cuda_device, d):
    g = generators.rmat(8, 6, seed=8)
    packed = pack_blocked(block_png(build_png(
        g, Partitioning(g.num_nodes, 64))), g.num_nodes, edge_block=128,
        device=cuda_device)
    eu, ed = packed.edge_upd.clone(), packed.edge_dst.clone()
    eu[1] = packed.update_src.shape[1]
    ed[1] = packed.part_size
    x = torch.rand((g.num_nodes, d), device=cuda_device)
    for form, (out, ref) in _warp_both_forms(x, packed, eu, ed).items():
        assert torch.count_nonzero(out[1]) == 0, form
        assert torch.count_nonzero(out) > 0, form
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [1, 16])
def test_b1_warp_fused_update_src_outside_x_makes_pads(cuda_device, d):
    """An ``update_src`` entry outside [0, n) makes the edges that read it
    pads on the card, as in the plain version (rows that are multiples of
    1/16: exact)."""
    g = generators.rmat(8, 6, seed=8)
    packed = pack_blocked(block_png(build_png(
        g, Partitioning(g.num_nodes, 64))), g.num_nodes, edge_block=128,
        device=cuda_device)
    bad = packed.update_src.clone()
    bad[0, 0], bad[1, 1] = g.num_nodes, -1
    x = (torch.randint(0, 16, (g.num_nodes, d), device=cuda_device).float()
         / 16)
    args = (x, bad, packed.edge_upd, packed.edge_dst)
    out = _warp_call(pcpm_spmv_cuda, *args, part_size=packed.part_size)
    assert torch.equal(out, pcpm_spmv_ref(*args, part_size=packed.part_size))


def test_b1_warp_fused_rejects_what_it_cannot_take(cuda_device):
    g = generators.rmat(8, 6, seed=8)
    packed = pack_blocked(block_png(build_png(
        g, Partitioning(g.num_nodes, 64))), g.num_nodes, edge_block=128,
        device=cuda_device)
    args = (packed.update_src, packed.edge_upd, packed.edge_dst)
    x = torch.rand((16, g.num_nodes), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        pcpm_spmv_cuda(x.t(), *args, part_size=packed.part_size)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pcpm_spmv_cuda(x.t().contiguous().half(), *args,
                       part_size=packed.part_size)
    with pytest.raises(ValueError, match="device"):
        pcpm_spmv_cuda(x.t().contiguous().cpu(), *args,
                       part_size=packed.part_size)


def test_b1_warp_spmv_allocates_no_bins(cuda_device):
    """``pcpm_spmv_pallas`` at d = 16 through the fused form: the peak
    memory of the call is its (k, P, 16) output and not the (k, U, 16)
    bins, which at this layout are 7.6 times larger."""
    g = generators.rmat(14, 16, seed=1)
    blk = block_png(build_png(g, Partitioning(g.num_nodes, 512)))
    packed = pack_blocked(blk, g.num_nodes, device=cuda_device)
    k, u = packed.update_src.shape
    x = torch.rand((g.num_nodes, 16), device=cuda_device)
    bins_bytes = k * u * 16 * 4
    out_bytes = k * packed.part_size * 16 * 4
    assert bins_bytes > 7 * out_bytes
    pcpm_spmv_pallas(packed, x)                    # builds, warms up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = _warp_call(pcpm_spmv_pallas, packed, x)
    peak = torch.cuda.max_memory_allocated() - base
    assert peak < out_bytes + bins_bytes // 4
    want = pcpm_spmv_pallas(pack_blocked(blk, g.num_nodes, device="cpu"),
                            x.cpu())
    torch.testing.assert_close(y.cpu(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------- PageRank serving through B1
def _serving_workload(n):
    rng = np.random.default_rng(3)
    work = []
    for i in range(24):
        seed = np.zeros(n, np.float32)
        seed[rng.integers(0, n, size=1 + (i % 3))] = 1.0
        fixed = i % 2 == 0
        work.append((None if i % 4 == 0 else seed,
                     dict(tol=0.0 if fixed else 1e-6,
                          max_iters=9 + i if fixed else 200,
                          top_k=10 if i % 4 == 3 else None)))
    return work


@pytest.mark.parametrize("method", ["pcpm", "pcpm_pallas"])
def test_slot_scheduler_on_the_card_matches_cpu(cuda_device, method):
    """The stepper on the card: "warp" launches equal the iterations the
    chunks ran (pcpm_pallas), fixed-count queries equal the CPU's ranks,
    converged ones the dense oracle at their own count (the card's and
    the CPU's sums round apart, so a residual within rounding of tol may
    stop one iteration apart)."""
    from repro_torch.serve import SlotScheduler
    g = generators.rmat(10, 8, seed=0)
    kw = dict(method=method, part_size=256, slots=4, chunk=4,
              route="stepper")
    card = SlotScheduler(g, device=cuda_device, **kw)
    cpu = SlotScheduler(g, device="cpu", **kw)
    iters = []
    real = card._step_c

    def step(*a):
        out = real(*a)
        iters.append(int(out[2].max()))
        return out

    card._step_c = step
    work = _serving_workload(g.num_nodes)
    uids = [(card.submit(s, **w), cpu.submit(s, **w)) for s, w in work]
    before = dict(kernel.launch_counts)
    card.run_until_drained()
    torch.cuda.synchronize()
    warp = kernel.launch_counts["warp"] - before["warp"]
    assert warp == (sum(iters) if method == "pcpm_pallas" else 0)
    assert kernel.launch_counts["tile"] == before["tile"]
    cpu.run_until_drained()
    done = ({r.uid: r for r in card.completed},
            {r.uid: r for r in cpu.completed})
    for (seed, w), (a, b) in zip(work, uids):
        ra, rb = done[0][a], done[1][b]
        if w["tol"] == 0.0:
            assert ra.iterations == rb.iterations == w["max_iters"]
            if ra.ranks is not None:
                assert np.abs(ra.ranks - rb.ranks).max() <= 1e-6
            else:
                np.testing.assert_allclose(ra.top_scores, rb.top_scores,
                                           atol=1e-6)
        else:
            assert ra.converged and rb.converged
            assert abs(ra.iterations - rb.iterations) <= 1
            col = seed / seed.sum()
            x = col.astype(np.float64)
            inv = np.where(g.out_degree == 0, 0.0,
                           1.0 / np.maximum(g.out_degree, 1))
            for _ in range(ra.iterations):
                x = 0.15 * col + 0.85 * dense_spmv(g.num_nodes, g.src,
                                                   g.dst, x * inv)
            if ra.ranks is not None:
                assert np.abs(ra.ranks - x).max() <= 1e-5
            else:
                assert np.abs(ra.top_scores - x[ra.top_ids]).max() <= 1e-5
    card.metrics.reconcile()


def test_pagerank_server_on_the_card_runs_warp_and_tile(cuda_device):
    g = generators.rmat(10, 8, seed=0)
    sess = repro_torch.open(g, method="pcpm_pallas", part_size=256)
    cpu = repro_torch.open(g, method="pcpm_pallas", part_size=256,
                           device="cpu")
    rng = np.random.default_rng(1)
    seeds = (rng.random((g.num_nodes, 4)) < 0.05).astype(np.float32) + 1e-3
    for batch, path in ((4, "warp"), (1, "tile")):
        arg = seeds if batch > 1 else seeds[:, 0]
        before = dict(kernel.launch_counts)
        pr, it, res = sess.server(batch=batch).query(arg)
        torch.cuda.synchronize()
        assert kernel.launch_counts[path] - before[path] == it == 20
        other = "tile" if path == "warp" else "warp"
        assert kernel.launch_counts[other] == before[other]
        ref, _, _ = cpu.server(batch=batch).query(arg)
        assert np.abs(pr.cpu().numpy() - ref.numpy()).max() <= 1e-6


def test_device_push_on_the_card(cuda_device):
    """Push on a pcpm_pallas plan on the card, picked by ``"auto"``: B1
    "tile" once for the seeding step and once per sweep; the estimate
    within the host push's bound."""
    from repro_torch.core import SpMVEngine
    from repro_torch.serve import PushQueryEngine
    g = generators.rmat(10, 8, seed=1)
    eng = PushQueryEngine(g, SpMVEngine(g, method="pcpm_pallas",
                                        part_size=256))
    host = PushQueryEngine(g)
    assert (eng.mode, host.mode) == ("device", "host")     # "auto"
    seed = np.zeros(g.num_nodes, np.float32)
    seed[int(np.argmax(g.out_degree))] = 1.0
    before = kernel.launch_counts["tile"]
    res = eng.query(seed, tol=1e-4, top_k=10)
    assert res.converged
    assert kernel.launch_counts["tile"] - before == res.sweeps + 1
    ref = host.query(seed, tol=1e-4)
    assert np.abs(res.estimate - ref.estimate).sum() <= 2e-4 * 0.85 / 0.15


# ------------------------------------------------- streaming edge deltas
def _local_delta(g, rng, parts, part_size, count=64, n_add=None):
    """``count`` removals and ``n_add`` (default ``count``) insertions
    with destinations in ``parts``."""
    from repro_torch.stream import GraphDelta
    n_add = count if n_add is None else n_add
    pool = np.flatnonzero(np.isin(g.dst // part_size, parts))
    ridx = rng.choice(pool, size=count, replace=False)
    dst = rng.choice(parts, n_add) * part_size + rng.integers(
        0, part_size, n_add)
    add = np.stack([rng.integers(0, g.num_nodes, n_add),
                    np.minimum(dst, g.num_nodes - 1)], 1).astype(np.int32)
    return GraphDelta.of(add=add, remove=np.stack([g.src[ridx],
                                                   g.dst[ridx]], 1))


@pytest.mark.parametrize("method", METHODS)
def test_patched_plan_on_the_card_matches_cpu(cuda_device, method):
    from repro_torch.core import PlanConfig, SpMVEngine, build_plan
    from repro_torch.stream import apply_delta, patch_plan
    rng = np.random.default_rng(4)
    g = generators.rmat(10, 8, seed=2)
    plan = build_plan(g, PlanConfig(method=method, part_size=256))
    delta = _local_delta(g, rng, [1], 256)
    g2 = apply_delta(g, delta)
    patched = patch_plan(plan, delta, g2)
    # multiples of 1/64: every summation order gives the same bits
    x = (rng.integers(0, 64, g.num_nodes) / 64).astype(np.float32)
    before = dict(kernel.launch_counts)
    y = SpMVEngine(g2, plan=patched, device=cuda_device)(x)
    torch.cuda.synchronize()
    tile = kernel.launch_counts["tile"] - before["tile"]
    assert tile == (1 if method == "pcpm_pallas" else 0)
    want = SpMVEngine(g2, plan=patched, device="cpu")(x)
    assert torch.equal(y.cpu(), want)
    assert np.array_equal(want.numpy(), dense_spmv(
        g.num_nodes, g2.src, g2.dst, x).astype(np.float32))


def test_b1_on_a_patched_plan_vs_plain(cuda_device):
    """Both paths of B1 on the streams of a patched pcpm_pallas plan
    (new ``max_u``/``max_e``, a new "tile" order), bit for bit."""
    from repro_torch.core import PlanConfig, build_plan
    from repro_torch.stream import apply_delta, patch_plan
    rng = np.random.default_rng(6)
    g = generators.rmat(11, 8, seed=3)
    plan = build_plan(g, PlanConfig(method="pcpm_pallas", part_size=256))
    # insertions into the fullest partition: the blocked streams widen
    fullest = int(np.argmax(np.diff(plan.png.edge_offsets)))
    delta = _local_delta(g, rng, [fullest, 5], 256, count=100, n_add=600)
    patched = patch_plan(plan, delta, apply_delta(g, delta))
    assert patched.blocked.edge_dst_local.shape != \
        plan.blocked.edge_dst_local.shape
    packed = pack_blocked(patched.blocked, g.num_nodes, device=cuda_device)
    schedule = tile_schedule(patched.blocked, device=cuda_device)
    k, u = packed.update_src.shape
    for d in (1, 16):
        x = torch.randint(0, 16, (g.num_nodes, d), device=cuda_device,
                          generator=torch.Generator(cuda_device)
                          .manual_seed(d)).float() / 16
        bins = x[packed.update_src.view(-1)].view(k, u, d)
        ref = pcpm_gather_ref(bins, packed.edge_upd, packed.edge_dst,
                              part_size=256)
        if d == 1:
            assert torch.equal(_tile_call(bins, packed, schedule), ref)
        for out, plain in _warp_both_forms(x, packed).values():
            assert torch.equal(out, plain)


def test_session_delta_and_warm_update_on_the_card(cuda_device):
    """``apply_delta`` twice, then ``pagerank(warm=True)`` on the card:
    one B1 "tile" launch per push sweep, no "warp"; ranks within 1e-6 of
    the same steps on the CPU; the old plan's uploads released."""
    from repro_torch.stream import apply_delta
    rng = np.random.default_rng(8)
    g = generators.rmat(11, 8, seed=3)
    d1 = _local_delta(g, rng, [1, 6], 256)
    d2 = _local_delta(apply_delta(g, d1), rng, [3], 256)
    runs = {}
    for dev in (cuda_device, "cpu"):
        sess = repro_torch.open(g, method="pcpm_pallas", part_size=256,
                                device=dev)
        sess.pagerank(num_iterations=300, tol=1e-6)
        old = sess.plan
        sess.apply_delta(d1).apply_delta(d2)
        assert len(old._device) == 0
        before = dict(kernel.launch_counts)
        res = sess.pagerank(warm=True, tol=1e-6, num_iterations=300)
        torch.cuda.synchronize()
        runs[str(dev)] = (res, {p: kernel.launch_counts[p] - before[p]
                                for p in before})
    (card, counts), (cpu, _) = runs[str(cuda_device)], runs["cpu"]
    assert 0 < card.iterations < 100
    assert counts == {"tile": card.iterations, "warp": 0}
    assert abs(card.iterations - cpu.iterations) <= 1     # float32 stops
    assert np.abs(card.ranks.cpu().numpy()
                  - cpu.ranks.numpy()).max() <= 1e-6


def test_slot_scheduler_apply_delta_on_the_card(cuda_device):
    """A rebind under in-flight queries on the card: the new plan's
    stepper runs B1 "warp" once per chunk iteration and nothing else;
    the answers within 1e-6 of the same run on the CPU."""
    from repro_torch.serve import SlotScheduler
    from repro_torch.stream import apply_delta
    rng = np.random.default_rng(9)
    g = generators.rmat(10, 8, seed=0)
    delta = _local_delta(g, rng, [2], 256)
    g2 = apply_delta(g, delta)
    kw = dict(method="pcpm_pallas", part_size=256, slots=4, chunk=4,
              route="stepper")
    runs = []
    for dev in (cuda_device, "cpu"):
        sch = SlotScheduler(g, device=dev, **kw)
        iters = []
        for s, w in _serving_workload(g.num_nodes)[:8]:
            sch.submit(s, **w)
        sch.step()
        old = sch.engine.plan
        sch.apply_delta(delta, g_new=g2)
        assert sch.rebind_count == 1 and len(old._device) == 0
        real = sch._step_c

        def step(*a, real=real, iters=iters):
            out = real(*a)
            iters.append(int(out[2].max()))
            return out

        sch._step_c = step
        before = dict(kernel.launch_counts)
        sch.run_until_drained()
        torch.cuda.synchronize()
        sch.metrics.reconcile()
        runs.append((sch, iters, {p: kernel.launch_counts[p] - before[p]
                                  for p in before}))
    (card, iters, counts), (cpu, _, _) = runs
    assert counts == {"warp": sum(iters), "tile": 0} and sum(iters) > 0
    a = sorted(card.completed, key=lambda r: r.uid)
    b = sorted(cpu.completed, key=lambda r: r.uid)
    assert len(a) == len(b) == 8
    for ra, rb in zip(a, b):
        assert abs(ra.iterations - rb.iterations) <= 1
        if ra.ranks is not None:
            assert np.abs(ra.ranks - rb.ranks).max() <= 1e-6
        else:
            np.testing.assert_allclose(ra.top_scores, rb.top_scores,
                                       atol=1e-6)


# ------------------------------------------------------------- kernel B3
def _attn_inputs(dev, shape, dtype, seed, kv_dtype=None):
    b, hq, hkv, sq, skv, d = shape
    rng = np.random.default_rng(seed)

    def mk(*dims, dt):
        return torch.from_numpy(rng.standard_normal(dims).astype(
            np.float32)).to(dev, dt)
    return (mk(b, sq, hq, d, dt=dtype), mk(b, skv, hkv, d, dt=kv_dtype or dtype),
            mk(b, skv, hkv, d, dt=kv_dtype or dtype))


B3_CASES = [  # (b, hq, hkv, sq, skv, d), window: TestFlashAttention's
    ((1, 4, 4, 256, 256, 64), None), ((2, 8, 2, 128, 128, 64), None),
    ((1, 4, 1, 384, 384, 128), None), ((1, 2, 2, 384, 384, 64), 64),
    ((1, 2, 2, 384, 384, 64), 128), ((1, 2, 2, 384, 384, 64), 200),
    ((1, 2, 2, 200, 200, 64), None), ((2, 4, 2, 70, 130, 32), None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,window", B3_CASES)
def test_b3_vs_plain(cuda_device, shape, window, dtype):
    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(cuda_device, shape, dt, seed=sum(shape))
    before = b3.kernel.launch_count
    path = "tc" if dtype == "bfloat16" else "simt"
    before_path = b3.kernel.launch_counts[path]
    out = b3.flash_attention_cuda(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert b3.kernel.launch_count == before + 1
    assert b3.kernel.launch_counts[path] == before_path + 1
    assert out.dtype == dt
    ref = b3.attention_ref(q.float(), k.float(), v.float(), causal=True,
                           window=window)
    tol = 2e-3 if dtype == "float32" else 5e-2
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_b3_prefill_per_row_kv_len(cuda_device, d, dtype):
    """Sq > 1 with per-row lengths, one of them 0 (a block that walks no
    tile must still write zeros), through "tc" (bfloat16) or "simt"."""
    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(cuda_device, (3, 8, 2, 96, 160, d), dt, seed=d)
    kv_len = torch.tensor([0, 37, 150], dtype=torch.int32,
                          device=cuda_device)
    path = "tc" if dtype == "bfloat16" else "simt"
    before = b3.kernel.launch_counts[path]
    out = b3.flash_attention_cuda(q, k, v, causal=True, kv_len=kv_len)
    torch.cuda.synchronize()
    assert b3.kernel.launch_counts[path] == before + 1
    ref = b3.attention_ref(q.float(), k.float(), v.float(), causal=True,
                           kv_len=kv_len)
    tol = (dict(rtol=1.6e-2, atol=2e-3) if dtype == "bfloat16"
           else dict(rtol=2e-3, atol=2e-3))
    torch.testing.assert_close(out.float(), ref, **tol)
    assert not out[0].any()


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_b3_decode_per_slot_kv_len_on_a_cache_view(cuda_device, q_dtype):
    """Sq = 1 against one layer of a bfloat16 (L, B, slots, Hkv, D) cache,
    read in place through its strides, with per-slot lengths."""
    cache = torch.randn((3, 8, 256, 4, 64), device=cuda_device).to(
        torch.bfloat16)
    kc, vc = cache[1], cache[2]
    q = torch.randn((8, 1, 32, 64), device=cuda_device).to(
        getattr(torch, q_dtype))
    kv_len = torch.tensor([1, 5, 31, 32, 33, 200, 256, 0],
                          dtype=torch.int32, device=cuda_device)
    before = b3.kernel.launch_counts["split"]
    out = b3.attention(q, kc, vc, causal=False, kv_len=kv_len)
    torch.cuda.synchronize()
    assert b3.kernel.launch_counts["split"] == before + 1
    ref = b3.attention_ref(q.float(), kc.float(), vc.float(), causal=False,
                           kv_len=kv_len)
    assert out.dtype == getattr(torch, q_dtype)
    # bfloat16 out: its rounding only (float32 sums), not TestFlashAttention's
    # 5e-2, which is the size of |o| itself over hundreds of keys
    tol = (dict(rtol=2e-3, atol=2e-3) if q_dtype == "float32"
           else dict(rtol=1.6e-2, atol=2e-3))
    torch.testing.assert_close(out.float(), ref, **tol)
    assert not out[7].any()


@pytest.mark.parametrize("view", ["cache", "unaligned"])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("bfloat16", "bfloat16"), ("float32", "bfloat16"), ("float32", "float32")])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_b3_split_decode_across_chunk_edges(cuda_device, d, q_dtype,
                                            kv_dtype, view):
    """Sq = 1 through the "split" path, lengths on both sides of the
    64-key chunk edges, k and v read in place from one layer of an
    (L, B, slots, Hkv, D) cache or from views off 16-byte alignment."""
    lens = [0, 1, 63, 64, 65, 1024]
    kdt = getattr(torch, kv_dtype)
    if view == "cache":
        cache = torch.randn((3, len(lens), 1024, 4, d),
                            device=cuda_device).to(kdt)
        k, v = cache[1], cache[2]
    else:
        base = torch.randn((len(lens), 1024, 4, d + 1),
                           device=cuda_device).to(kdt)
        k, v = base[..., 1:], base[..., :d]
    q = torch.randn((len(lens), 1, 32, d), device=cuda_device).to(
        getattr(torch, q_dtype))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = dict(b3.kernel.launch_counts)
    out = b3.flash_attention_cuda(q, k, v, causal=False, kv_len=kv_len)
    torch.cuda.synchronize()
    assert b3.kernel.launch_counts == {**before,
                                       "split": before["split"] + 1}
    ref = b3.attention_ref(q.float(), k.float(), v.float(), causal=False,
                           kv_len=kv_len)
    # float32 out: sums in another order; bfloat16 out: its rounding
    tol = (dict(rtol=1.6e-2, atol=2e-3) if out.dtype == torch.bfloat16
           else dict(rtol=2e-3, atol=2e-3))
    torch.testing.assert_close(out.float(), ref, **tol)
    assert not out[0].any()


def test_b3_rejects_what_it_cannot_take(cuda_device):
    q, k, v = _attn_inputs(cuda_device, (1, 4, 2, 8, 8, 48), torch.float32, 0)
    with pytest.raises(ValueError, match="head size"):
        b3.flash_attention_cuda(q, k, v)
    q, k, v = _attn_inputs(cuda_device, (1, 4, 2, 8, 8, 64), torch.float32, 0)
    with pytest.raises(ValueError, match="contiguous last"):
        b3.flash_attention_cuda(q, k.transpose(2, 3).contiguous()
                                .transpose(2, 3), v)


def test_serve_engine_on_the_card_matches_cpu(cuda_device):
    cfg = configs.get("tinyllama-1.1b").scaled()
    cpu_model = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)

    def run(model):
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, int(
            rng.integers(3, 20))).tolist(), max_new_tokens=10)
            for i in range(10)]
        reqs.append(Request(uid=99, prompt=[1] * 60, max_new_tokens=10))
        eng = ServeEngine(cfg, model, batch_slots=4, max_len=64)
        return eng, eng.run_until_drained(reqs)

    before = b3.kernel.launch_count
    gpu_eng, on_card = run(gpu_model)
    torch.cuda.synchronize()
    assert b3.kernel.launch_count - before == cfg.n_layers * gpu_eng.steps
    cpu_eng, on_cpu = run(cpu_model)
    assert gpu_eng.steps == cpu_eng.steps
    assert [(r.generated, r.error) for r in on_card] == [
        (r.generated, r.error) for r in on_cpu]
    assert on_card[-1].error is not None


# ------------------------------------------------------------ kernel B2
B2_SHAPES = [(512, 128, 8, 4), (1024, 64, 32, 16), (2048, 128, 64, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,d,b,l", B2_SHAPES)
def test_b2_vs_plain(cuda_device, v, d, b, l, dtype):
    rng = np.random.default_rng(v + d + b)
    table = torch.from_numpy(rng.random((v, d)).astype(np.float32)).to(
        cuda_device, getattr(torch, dtype))
    idx = torch.from_numpy(rng.integers(0, v, (b, l))).to(cuda_device)
    idx[0, -1] = v                                   # a pad
    w = torch.from_numpy(rng.random((b, l)).astype(np.float32)).to(
        cuda_device)
    for ids in (idx, idx.to(torch.int32)):
        before = b2.kernel.launch_count
        out = b2.embedding_bag(table, ids, w)
        torch.cuda.synchronize()
        assert b2.kernel.launch_count == before + 1
        assert out.dtype == table.dtype
        # TestEmbeddingBag's tolerance; bfloat16: one rounding of float32
        # sums taken in another order can differ by one bfloat16 step
        tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
               else dict(rtol=2 ** -7, atol=1e-5))
        torch.testing.assert_close(
            out.float(), b2.embedding_bag_ref(table, ids, w).float(), **tol)


@pytest.mark.parametrize("d", [64, 6, 13, 1030])
def test_b2_pads_negatives_tails_and_odd_views(cuda_device, d):
    v = 300
    base = torch.rand((v, d + 4), device=cuda_device)
    table = base[:, 1:1 + d]                  # every row off 16 B alignment
    idx = torch.randint(-2, v + 3, (40, 5), device=cuda_device)
    idx[0] = v
    for t in (table, table.contiguous()):
        out = b2.embedding_bag(t, idx)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, b2.embedding_bag_ref(t, idx),
                                   rtol=1e-6, atol=1e-6)
        assert not out[0].any()
    one = b2.embedding_bag(table, idx.reshape(-1, 1))        # one-id bags
    assert torch.equal(one, b2.embedding_bag_ref(table, idx.reshape(-1, 1)))


def test_b2_rejects_what_it_cannot_take(cuda_device):
    table = torch.rand((16, 8), device=cuda_device)
    idx = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous last"):
        b2.embedding_bag(table.t().contiguous().t(), idx)
    with pytest.raises(TypeError, match="int32 or int64"):
        b2.embedding_bag(table, idx.to(torch.int16))
    with pytest.raises(ValueError, match="one device"):
        b2.embedding_bag(table, idx.cpu())


def test_b2_lookup_writes_the_ids_shape(cuda_device):
    table = torch.rand((300, 64), device=cuda_device)
    ids = torch.randint(-2, 310, (7, 50), device=cuda_device)
    for view in (ids, ids.t(), ids[:, ::3]):
        before = b2.kernel.launch_count
        rows = b2.embedding_lookup(table, view)
        torch.cuda.synchronize()
        assert b2.kernel.launch_count == before + 1
        assert rows.shape == (*view.shape, 64)
        assert torch.equal(rows, b2.embedding_bag_ref(
            table, view.reshape(-1, 1)).reshape(rows.shape))


def test_mind_on_the_card_matches_cpu(cuda_device):
    cfg = configs.get("mind").scaled()
    cpu_model = recsys.init_mind(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    rng = np.random.default_rng(0)
    hist = rng.integers(0, cfg.vocab, (32, cfg.hist_len)).astype(np.int32)
    hist[:, -3:] = cfg.vocab
    hist[5] = cfg.vocab
    cand = torch.from_numpy(rng.permutation(cfg.vocab)[:500])
    h = torch.from_numpy(hist)
    before = b2.kernel.launch_count
    caps = recsys.serve_step(gpu_model, cfg, h.to(cuda_device))
    torch.cuda.synchronize()
    assert b2.kernel.launch_count == before + 1
    scores, ids = recsys.retrieval_step(gpu_model, cfg, h[:2].to(cuda_device),
                                        cand.to(cuda_device), top_k=16)
    torch.cuda.synchronize()
    assert b2.kernel.launch_count == before + 3
    torch.testing.assert_close(caps.cpu(), recsys.serve_step(cpu_model, cfg, h),
                               rtol=1e-5, atol=1e-6)
    assert not caps[5].any()
    ref_scores, ref_ids = recsys.retrieval_step(cpu_model, cfg, h[:2], cand,
                                                top_k=16)
    torch.testing.assert_close(scores.cpu(), ref_scores, rtol=1e-5,
                               atol=1e-6)
    apart = torch.ones_like(ref_scores, dtype=torch.bool)
    gaps = ref_scores.diff(dim=1).abs() > 1e-5
    apart[:, 1:] &= gaps
    apart[:, :-1] &= gaps
    assert torch.equal(ids.cpu()[apart], ref_ids[apart])
