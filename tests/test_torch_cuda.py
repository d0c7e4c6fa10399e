"""The port on the card: kernel B1 against its plain version through
both of its paths ("warp", "tile"; "tile" also over ragged bins against
padded ones), and the main path ``open(g, device="cuda").pagerank()``
against the same solve on the CPU and the dense oracle, also replayed
on a hub-first plan; PageRank serving (``SlotScheduler``,
``PageRankServer``, device push) with B1's launches counted per path;
streaming deltas (patched plans of each method against the CPU, B1 on a
patched plan against its plain version, ``Session.apply_delta`` with a
warm update and ``SlotScheduler.apply_delta`` with launches counted by
path); reliability (a poisoned column quarantined on the card, scheduler
snapshot/restore, a rank checkpoint round trip); the observed gateway
(autotuned width, launches by path, one upload per plan under racing
threads, observability's cost in queries/s); the sharded path at world
size 1 through a one-rank NCCL group (PageRank, the engine's SpMV, a
sharded scheduler and server, each against the CPU, with the mesh's
collectives counted; the PCPM-distributed GraphCast against the
single-device forward and gradients on the same edges); kernel B3 against its plain version
through each of its paths ("tc", "simt", "split"), with grok-1's GQA
group of 6 and a windowed "tc" prefill, the smoke LM's ``ServeEngine``
on the card against the same run on the CPU, and the MoE smoke models'
``forward``, ``prefill`` and serving against the CPU; kernel B2
against its plain version (lookups bit for bit: widths, unaligned
views, int32 and int64 ids, a persistent grid over 13M bags), and the
smoke MIND's
``serve_step``/``retrieval_step`` on the card against the CPU; kernel
B2-bwd against its plain backward (bit-equal on exact sums, its CPU
emulation's bits on random ones, pads, a negative id, bfloat16, a hot
row, d 6272 through its slab walk, two calls bit-identical) and the smoke MIND's train step on the card
against the CPU; ``segment_sum`` (B2-bwd forward, B2 backward) against
its CPU path, and each smoke GNN's gradients and train steps on the card
against the CPU, with B2 and B2-bwd launched as ``gnn.kernel_calls``
counts and a repeated step bit for bit.

Every test is marked ``cuda`` and skips without a card. The file needs
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch for CUDA:  ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.core import (Partitioning, block_png, build_png,
                              pagerank_reference)
from repro_torch.graphs import generators
from repro_torch.kernels.pcpm_spmv import (kernel, ops, pack_blocked,
                                           pcpm_gather_cuda, pcpm_gather_ref,
                                           pcpm_spmv_cuda, pcpm_spmv_pallas,
                                           pcpm_spmv_ref, tile_gather_cuda,
                                           tile_gather_ref, tile_schedule)
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
def _ragged(png, x):
    """The PNG's own bins ``x[update_src]`` (U,) and their offsets, on
    x's device."""
    dev = x.device
    upd = torch.from_numpy(png.update_src).to(dev)
    offsets = torch.from_numpy(png.update_offsets.astype(np.int32)).to(dev)
    return x.index_select(0, upd), offsets


def _tile_inputs(dev, scale, deg, part_size, seed):
    """A rmat layout on the card: its PNG, its packed blocked streams,
    and for an x whose values are multiples of 1/16 (sums exact in any
    order) the padded bins (k, U, 1) the plain blocked gather reads and
    the ragged bins (U,) with offsets that B1 "tile" reads."""
    g = generators.rmat(scale, deg, seed=scale)
    png = build_png(g, Partitioning(g.num_nodes, part_size))
    packed = pack_blocked(block_png(png), g.num_nodes, edge_block=128,
                          device=dev)
    x = torch.from_numpy((np.random.default_rng(seed).integers(
        0, 16, g.num_nodes) / 16).astype(np.float32)).to(dev)
    k, u = packed.update_src.shape
    bins = x[packed.update_src.view(-1)].view(k, u, 1)
    return png, packed, bins, *_ragged(png, x)


def _tile_call(ragged, offsets, schedule):
    before = dict(kernel.launch_counts)
    out = tile_gather_cuda(ragged, offsets, schedule)
    torch.cuda.synchronize()
    assert kernel.launch_counts["tile"] == before["tile"] + 1
    assert kernel.launch_counts["warp"] == before["warp"]
    return out


@pytest.mark.parametrize("tile_bytes", [64, ops.TILE_BYTES])
@pytest.mark.parametrize("scale,deg,part_size", [s[:3] for s in SHAPES])
def test_b1_tile_vs_plain(cuda_device, scale, deg, part_size, tile_bytes):
    png, packed, bins, ragged, offsets = _tile_inputs(
        cuda_device, scale, deg, part_size, seed=scale)
    schedule = tile_schedule(png, tile_bytes=tile_bytes, device=cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        out = _tile_call(ragged.to(dtype), offsets, schedule)
        ref = pcpm_gather_ref(bins.to(dtype), packed.edge_upd,
                              packed.edge_dst, part_size=part_size)
        assert out.dtype == dtype and torch.equal(out, ref)


def test_b1_tile_all_pad_partition(cuda_device):
    # partition 0 has no edge at all (no update, no chunk): zeros
    from repro_torch.graphs.formats import from_edge_list
    part_size = 8
    g = from_edge_list(2 * part_size, np.array([[0, 15], [1, 10], [1, 13]],
                                               dtype=np.int32))
    png = build_png(g, Partitioning(g.num_nodes, part_size))
    assert png.update_offsets.tolist() == [0, 0, 2]
    schedule = tile_schedule(png, tile_bytes=16, device=cuda_device)
    ragged, offsets = _ragged(png, torch.rand(g.num_nodes,
                                              device=cuda_device))
    out = _tile_call(ragged, offsets, schedule)
    assert torch.count_nonzero(out[0]) == 0
    torch.testing.assert_close(out, tile_gather_ref(
        ragged.cpu(), tile_schedule(png, tile_bytes=16, device="cpu"),
        offsets.cpu()).to(cuda_device), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("order", ["dst-sorted", "random"])
def test_b1_tile_edges_outside_their_chunks_tile(cuda_device, order):
    _, packed, bins, ragged, offsets = _tile_inputs(cuda_device, 8, 6, 64,
                                                    seed=1)
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
    out = _tile_call(ragged, offsets, schedule)
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


@pytest.mark.parametrize("labels", ["random", "degree"])
@pytest.mark.parametrize("scale,deg,part_size", [s[:3] for s in SHAPES])
def test_b1_tile_ragged_bins_vs_padded(cuda_device, scale, deg, part_size,
                                       labels):
    """B1 "tile" over a PNG's own (U,) updates with their offsets (the
    d = 1 solve's bins) against B1 "warp" over the (k, U, 1) padded bins
    of the blocked streams, on random and hub-first labels, in float32
    and bfloat16: equal, on sums exact in any order; and the d = 1 SpMV
    of each layout."""
    from repro_torch.graphs.reorder import degree_order
    from repro_torch.kernels.pcpm_spmv import pcpm_spmv_tile
    g = generators.rmat(scale, deg, seed=scale)
    if labels == "degree":
        g = g.relabel(degree_order(g))
    png = build_png(g, Partitioning(g.num_nodes, part_size))
    packed = pack_blocked(block_png(png), g.num_nodes, edge_block=128,
                          device=cuda_device)
    schedule = tile_schedule(png, device=cuda_device)
    x = torch.from_numpy((np.random.default_rng(scale).integers(
        0, 16, g.num_nodes) / 16).astype(np.float32)).to(cuda_device)
    upd = torch.from_numpy(png.update_src).to(cuda_device)
    offsets = torch.from_numpy(png.update_offsets.astype(np.int32)).to(
        cuda_device)
    k, u = packed.update_src.shape
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        before = dict(kernel.launch_counts)
        ragged = _tile_call(xd.index_select(0, upd), offsets, schedule)
        padded = pcpm_gather_cuda(xd[packed.update_src.view(-1)].view(
            k, u, 1), packed.edge_upd, packed.edge_dst, part_size=part_size)
        torch.cuda.synchronize()
        assert kernel.launch_counts["warp"] == before["warp"] + 1
        assert ragged.dtype == dtype and torch.equal(ragged, padded)
    y = pcpm_spmv_tile(x, upd, offsets, schedule)
    assert torch.equal(y, pcpm_spmv_pallas(packed, x))


# ------------------------------- fixed-count solves replayed as CUDA graphs
def _graph_session(device, method="pcpm_pallas", **cfg):
    """An observed session on a fresh plan (so its second ``tol == 0``
    solve captures) and the module ``core/pagerank.py``."""
    import importlib
    from repro_torch.core.plan import clear_plan_cache
    clear_plan_cache()
    g = generators.rmat(11, 8, seed=7)
    sess = repro_torch.open(g, repro_torch.EngineConfig(
        method=method, part_size=256, observe=True, **cfg),
        device=device)
    return g, sess, importlib.import_module("repro_torch.core.pagerank")


def _graph_modes(sess):
    return [r.attrs["graph"] for r in sess.obs.recorder.snapshot()
            if r.name == "solve_launch"]


@pytest.mark.parametrize("check_every", [1, 3])
@pytest.mark.parametrize("dangling", ["none", "redistribute"])
@pytest.mark.parametrize("method", METHODS)
def test_graph_replay_matches_eager_and_oracle(cuda_device, method, dangling,
                                               check_every):
    """A replayed solve's ranks and residuals (the capturing solve's and
    a later one's) against the first solve, which runs eagerly, and the
    dense oracle, on every backend that does not shard."""
    g, sess, _ = _graph_session(cuda_device, method, dangling=dangling,
                                check_every=check_every)
    try:
        eager = sess.pagerank()
        replays = [sess.pagerank() for _ in range(2)]
        assert _graph_modes(sess) == ["eager", "capture", "replay"]
        oracle = pagerank_reference(g, dangling=dangling)
        for res in replays:
            assert res.iterations == eager.iterations == 20
            assert len(res.residuals) == len(eager.residuals) == (
                20 if check_every == 1 else 7)
            assert np.abs(np.subtract(res.residuals,
                                      eager.residuals)).max() <= 1e-6
            ranks = res.ranks.cpu().numpy()
            assert np.abs(ranks - eager.ranks.cpu().numpy()).max() <= 1e-6
            assert np.abs(ranks - oracle).max() <= 1e-6
    finally:
        sess.obs.close()


def test_degree_ordered_replayed_solve_matches_eager(cuda_device):
    """A hub-first plan's solves (eager, capturing, replayed) iterate in
    its relabeled ids through B1 "tile" and map the ranks back: equal to
    one another and to the dense oracle in the original ids; none builds
    the blocked form."""
    g, sess, _ = _graph_session(cuda_device, reorder="degree")
    try:
        before = dict(kernel.launch_counts)
        eager = sess.pagerank()
        replays = [sess.pagerank() for _ in range(2)]
        torch.cuda.synchronize()
        assert _graph_modes(sess) == ["eager", "capture", "replay"]
        assert kernel.launch_counts["tile"] - before["tile"] == 3 * 20
        assert kernel.launch_counts["warp"] == before["warp"]
        oracle = pagerank_reference(g)
        for res in replays:
            assert res.iterations == eager.iterations == 20
            ranks = res.ranks.cpu().numpy()
            assert np.abs(ranks - eager.ranks.cpu().numpy()).max() <= 1e-6
            assert np.abs(ranks - oracle).max() <= 1e-6
        assert sess.plan.blocked is None
        assert not [k for k in sess.plan._device if k[0] == "packed"]
    finally:
        sess.obs.close()


def test_graph_replay_counts_fresh_results_and_release(cuda_device):
    """Replays return fresh ranks (a held result survives the next
    solve), add their captured B1 launches, and reuse one capture; after
    ``release_device`` the loop starts over, eager then captured; a
    ``tol > 0`` solve stays eager and moves no graph counter."""
    from repro_torch.core.plan import release_device
    g, sess, solver = _graph_session(cuda_device)
    try:
        captures = solver.graph_captures
        sess.pagerank()
        replays = solver.graph_replays
        tiles = kernel.launch_counts["tile"]
        held = sess.pagerank()
        kept = held.ranks.clone()
        for _ in range(4):
            res = sess.pagerank()
        torch.cuda.synchronize()
        assert res.ranks.data_ptr() != held.ranks.data_ptr()
        assert torch.equal(held.ranks, kept)
        assert kernel.launch_counts["tile"] == tiles + 5 * 20
        assert solver.graph_replays == replays + 5
        assert solver.graph_captures == captures + 1
        release_device(sess.plan)
        sess.pagerank()
        assert solver.graph_captures == captures + 1
        again = sess.pagerank()
        assert solver.graph_captures == captures + 2
        assert np.abs(again.ranks.cpu().numpy()
                      - kept.cpu().numpy()).max() <= 1e-6
        counts = (solver.graph_captures, solver.graph_replays,
                  kernel.launch_counts["tile"])
        early = sess.pagerank(tol=1e-6, num_iterations=100)
        assert early.iterations < 100
        assert (solver.graph_captures, solver.graph_replays) == counts[:2]
        assert kernel.launch_counts["tile"] == counts[2] + early.iterations
        assert _graph_modes(sess) == (["eager", "capture"] + ["replay"] * 4
                                      + ["eager", "capture", "eager"])
    finally:
        sess.obs.close()


def test_held_graph_replays_after_release(cuda_device):
    """A graph held while ``release_device`` drops the plan's loop cache
    keeps the device layouts its kernels read: with the blocks the
    release freed written over, its replay still matches the first
    solve and a fresh one."""
    import gc
    from repro_torch.core.plan import release_device
    g, sess, _ = _graph_session(cuda_device)
    try:
        want = sess.pagerank().ranks.cpu().numpy()
        sess.pagerank()
        (solve,) = [v for k, v in sess.engine._fused_cache.items()
                    if k[0] == "graph"]
        release_device(sess.plan)
        gc.collect()
        junk = [torch.full((1 << s,), float("nan"), device=cuda_device)
                for s in range(6, 22) for _ in range(4)]
        ranks, it, _ = solve.replay()
        ranks = ranks.cpu().numpy()
        del junk
        fresh = sess.pagerank()
        assert it == fresh.iterations == 20
        assert np.abs(ranks - want).max() <= 1e-6
        assert np.abs(ranks - fresh.ranks.cpu().numpy()).max() <= 1e-6
    finally:
        sess.obs.close()


def test_paths_outside_the_graph_stay_eager(cuda_device):
    """The per-iteration loop (``driver="python"``), a ``tol > 0`` solve,
    ``PageRankServer``, the slot scheduler's stepper and the warm update
    after an edge delta capture and replay nothing: the graph counters
    stay and the plan's loop cache holds no graph."""
    from repro_torch.serve import SlotScheduler
    g, sess, solver = _graph_session(cuda_device)
    try:
        counts = solver.graph_captures, solver.graph_replays
        sess.pagerank(driver="python")
        sess.pagerank(tol=1e-6, num_iterations=300)
        seed = np.zeros(g.num_nodes, np.float32)
        seed[:8] = 1.0
        _, it, _ = sess.server(batch=1).query(seed)
        assert it == 20
        sch = SlotScheduler(g, engine=sess.engine, slots=4, chunk=4,
                            route="stepper")
        sch.submit(seed, tol=0.0, max_iters=8)
        sch.run_until_drained()
        assert len(sch.completed) == 1
        sess.apply_delta(_local_delta(g, np.random.default_rng(2), [1],
                                      256))
        warm = sess.pagerank(warm=True, tol=1e-6, num_iterations=300)
        assert warm.iterations < 300
        assert (solver.graph_captures, solver.graph_replays) == counts
        assert not [k for k in sess.engine._fused_cache if k[0] == "graph"]
        assert "capture" not in _graph_modes(sess)
    finally:
        sess.obs.close()


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
    from repro_torch.core.plan import blocked_of
    from repro_torch.stream import apply_delta, patch_plan
    rng = np.random.default_rng(6)
    g = generators.rmat(11, 8, seed=3)
    plan = build_plan(g, PlanConfig(method="pcpm_pallas", part_size=256))
    # insertions into the fullest partition: the blocked streams widen
    fullest = int(np.argmax(np.diff(plan.png.edge_offsets)))
    delta = _local_delta(g, rng, [fullest, 5], 256, count=100, n_add=600)
    patched = patch_plan(plan, delta, apply_delta(g, delta))
    blk = blocked_of(patched)
    assert blk.edge_dst_local.shape != \
        blocked_of(plan).edge_dst_local.shape
    packed = pack_blocked(blk, g.num_nodes, device=cuda_device)
    schedule = tile_schedule(patched.png, device=cuda_device)
    k, u = packed.update_src.shape
    for d in (1, 16):
        x = torch.randint(0, 16, (g.num_nodes, d), device=cuda_device,
                          generator=torch.Generator(cuda_device)
                          .manual_seed(d)).float() / 16
        bins = x[packed.update_src.view(-1)].view(k, u, d)
        ref = pcpm_gather_ref(bins, packed.edge_upd, packed.edge_dst,
                              part_size=256)
        if d == 1:
            out = _tile_call(*_ragged(patched.png, x[:, 0]), schedule)
            assert torch.equal(out, ref)
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


# ------------------------------------------------------------ reliability
def _stepper_drain(sch, seeds, iters=None):
    """Submit ``seeds`` (tol 1e-6), drain, and return the results in
    submit order; ``iters`` collects each chunk's iterations."""
    if iters is not None:
        real = sch._step_c

        def step(*a):
            out = real(*a)
            iters.append(int(out[2].max()))
            return out

        sch._step_c = step
    uids = [sch.submit(s, tol=1e-6, max_iters=300) for s in seeds]
    sch.run_until_drained()
    torch.cuda.synchronize()
    done = {r.uid: r for r in sch.completed}
    return [done[u] for u in uids]


def _seeds(g, k, seed=0):
    """``k`` teleport vectors of two seed nodes each, drawn among the
    nodes with out-edges (a seed without them converges at once)."""
    rng = np.random.default_rng(seed)
    ids = np.flatnonzero(np.asarray(g.out_degree) > 0)
    out = []
    for _ in range(k):
        s = np.zeros(g.num_nodes, np.float32)
        s[rng.choice(ids, size=2)] = 1.0
        out.append(s)
    return out


def test_poisoned_column_quarantined_on_the_card(cuda_device):
    """A NaN written into a slot column of the pool on the card freezes
    that column at once; the query is re-admitted from its clean seed and
    every query ends at the fault-free answers. B1 "warp" runs once per
    chunk iteration, poisoned chunk included."""
    from repro_torch.reliability import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.serve import SlotScheduler
    g = generators.rmat(10, 8, seed=0)
    kw = dict(method="pcpm_pallas", part_size=256, slots=4, chunk=4,
              route="stepper", device=cuda_device)
    seeds = _seeds(g, 8)
    clean = _stepper_drain(SlotScheduler(g, **kw), seeds)
    inj = FaultInjector(FaultPlan.of([FaultSpec("nan_slot", step=2,
                                                slot=1)]))
    sch = SlotScheduler(g, fault_injector=inj, **kw)
    iters = []
    before = dict(kernel.launch_counts)
    out = _stepper_drain(sch, seeds, iters)
    counts = {p: kernel.launch_counts[p] - before[p] for p in before}
    assert inj.exhausted and sch.trace_count == 1
    assert sch.metrics.counters["quarantined"] == 1
    assert sch.metrics.counters["requeued"] == 1
    assert counts == {"warp": sum(iters), "tile": 0}
    for a, b in zip(out, clean):
        assert a.converged and a.error is None
        assert np.abs(a.ranks - b.ranks).max() <= 1e-6


def test_snapshot_restore_on_the_card(cuda_device, tmp_path):
    """Snapshot an rmat(12) pcpm_pallas scheduler on the card three
    chunks in, restore it into a fresh one and drain: the iteration
    counts and ranks of the uninterrupted drain."""
    from repro_torch.reliability import restore_scheduler, snapshot_scheduler
    from repro_torch.serve import SlotScheduler
    g = generators.rmat(12, 8, seed=0)
    kw = dict(method="pcpm_pallas", part_size=512, slots=4, chunk=4,
              route="stepper", device=cuda_device)
    seeds = _seeds(g, 8, seed=1)
    clean = _stepper_drain(SlotScheduler(g, **kw), seeds)
    sch = SlotScheduler(g, **kw)
    uids = [sch.submit(s, tol=1e-6, max_iters=300) for s in seeds]
    for _ in range(3):
        sch.step()
    assert sch.active_slots == 4 and sch.queued == 4
    path = str(tmp_path / "sched.npz")
    snapshot_scheduler(sch, path)
    restored = restore_scheduler(path, g, **kw)
    assert restored.trace_count == 1
    assert restored._pr.device.type == "cuda"
    restored.run_until_drained()
    torch.cuda.synchronize()
    done = {r.uid: r for r in restored.completed}
    for u, want in zip(uids, clean):
        assert done[u].iterations == want.iterations
        assert np.abs(done[u].ranks - want.ranks).max() <= 1e-6


def test_rank_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """``save_checkpoint`` after a pcpm_pallas solve on the card, then a
    fresh session's ``load_checkpoint`` (ranks uploaded to the card) and
    ``pagerank(warm=True)``: fewer iterations than cold, within 1e-6."""
    g = generators.rmat(11, 8, seed=2)
    kw = dict(method="pcpm_pallas", part_size=256, tol=1e-6,
              num_iterations=300, device=cuda_device)
    sess = repro_torch.open(g, **kw)
    cold = sess.pagerank()
    path = str(tmp_path / "ck.npz")
    sess.save_checkpoint(path)
    fresh = repro_torch.open(g, **kw).load_checkpoint(path)
    assert fresh._solved_ranks.device.type == "cuda"
    before = dict(kernel.launch_counts)
    warm = fresh.pagerank(warm=True)
    torch.cuda.synchronize()
    counts = {p: kernel.launch_counts[p] - before[p] for p in before}
    assert len(warm.residuals) < len(cold.residuals)
    assert counts["warp"] == 0
    assert np.abs(warm.ranks.cpu().numpy()
                  - cold.ranks.cpu().numpy()).max() <= 1e-6
    cpu = repro_torch.open(g, method="pcpm_pallas", part_size=256,
                           device="cpu").load_checkpoint(path)
    assert torch.equal(cpu._solved_ranks, cold.ranks.cpu())


# ------------------------------------------------- gateway, observability
def _gateway_mix(n, count, seed=3):
    """(seeds, kwargs) in the chip smoke's serving mix by ``i % 4``:
    uniform, one seed top-k (pushed), four seeds, uniform top-k, each at
    a tolerance it reaches."""
    rng = np.random.default_rng(seed)
    work = []
    for i in range(count):
        kind = i % 4
        s = None
        if kind in (1, 2):
            s = np.zeros(n, np.float32)
            s[rng.integers(0, n, size=1 if kind == 1 else 4)] = 1.0
        work.append((s, dict(top_k=10 if kind in (1, 3) else None,
                             tol=1e-3 if kind == 1 else 1e-6,
                             max_iters=200)))
    return work


def test_gateway_on_the_card_matches_cpu(cuda_device):
    """The observed gateway over a pcpm_pallas plan on the card: the
    autotuned width, every future once, B1 "warp" once per chunk
    iteration and "tile" once per push sweep and seeding, one complete
    span tree per query, a repeat served bit-identical from the cache,
    answers within 1e-6 of the same requests on a CPU scheduler; B1
    "warp" at the autotuned width against its plain version on the
    plan's own tensors."""
    import threading
    from repro_torch.gateway import GatewayConfig
    from repro_torch.serve import SlotScheduler
    g = generators.rmat(11, 8, seed=4)
    sess = repro_torch.open(g, method="pcpm_pallas", part_size=256,
                            chunk=4, device=cuda_device)
    obs = sess.observe()
    cfg = GatewayConfig(target_chunk_s=10.0, autotune_candidates=(2, 4, 8),
                        push_workers=2)
    work = _gateway_mix(g.num_nodes, 24)
    gw = sess.gateway(config=cfg)
    sch = gw._schedulers["default"]
    assert gw.autotune_report.chosen == sch.slots == 8
    iters = []
    real = sch._step_c

    def step(*a):
        out = real(*a)
        iters.append(int(out[2].max()))
        return out

    sch._step_c = step
    before = dict(kernel.launch_counts)
    results = [None] * len(work)

    def submitter(part):
        futs = [(i, gw.submit(work[i][0], **work[i][1])) for i in part]
        for i, f in futs:
            results[i] = f.result(timeout=300)

    ts = [threading.Thread(target=submitter, args=(range(k, 24, 2),))
          for k in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts)
    torch.cuda.synchronize()
    counts = {p: kernel.launch_counts[p] - before[p] for p in before}
    repeat = gw.submit(work[2][0], **work[2][1]).result(timeout=300)
    gw.close()
    assert len({r.uid for r in results}) == 24
    assert all(r.error is None and r.converged for r in results)
    routes = [sch.metrics.traces[r.uid].route for r in results]
    # a uniform request may be served from the cache by the time its
    # twin is submitted
    assert [route == "push" for route in routes] == [
        i % 4 == 1 for i in range(24)]
    pushed = [r for r, route in zip(results, routes) if route == "push"]
    assert counts == {"warp": sum(iters),
                      "tile": sum(r.iterations + 1 for r in pushed)}
    assert sch.trace_count == 1
    assert repeat.cached and repeat.ranks is results[2].ranks
    sch.metrics.reconcile()
    by = {}
    for rec in obs.recorder.snapshot():
        by.setdefault(rec.trace, []).append(rec)
    for r in results:
        names = [rec.name for rec in by[r.uid]]
        assert names.count("query") == names.count("terminal") == 1
    # the card's push runs the device loop; so does this CPU scheduler's
    cpu = SlotScheduler(g, method="pcpm_pallas", part_size=256, chunk=4,
                        slots=8, push_mode="device", device="cpu")
    uids = [cpu.submit(s, **kw) for s, kw in work]
    cpu.run_until_drained()
    done = {r.uid: r for r in cpu.completed}
    for r, u in zip(results, uids):
        assert abs(r.iterations - done[u].iterations) <= 1
        if r.ranks is not None:
            assert np.abs(r.ranks - done[u].ranks).max() <= 1e-6
        else:
            np.testing.assert_allclose(r.top_scores, done[u].top_scores,
                                       atol=1e-6)
    packed = sess.plan._device[("packed", str(cuda_device))]
    x = torch.randint(0, 16, (g.num_nodes, sch.slots),
                      generator=torch.Generator().manual_seed(5)).float()
    x = (x / 16).to(cuda_device)
    got = pcpm_spmv_cuda(x, packed.update_src, packed.edge_upd,
                         packed.edge_dst, part_size=packed.part_size)
    want = pcpm_spmv_ref(x, packed.update_src, packed.edge_upd,
                         packed.edge_dst, part_size=packed.part_size)
    assert torch.equal(got, want)
    obs.close()


def test_span_ranges_stay_off_the_device_timeline(cuda_device):
    """Under ``torch.profiler`` with device tracing, an observed solve's
    spans are host ranges ``repro_torch::<name>`` and put nothing on the
    device timeline: a ``record_function`` range would come back there
    as a ``gpu_user_annotation``, which a union of device intervals
    (``bench/devtrace.py``) counts as busy time."""
    from torch.profiler import ProfilerActivity, profile
    g = generators.rmat(12, 8, seed=41)
    sess = repro_torch.open(g, repro_torch.EngineConfig(
        method="pcpm_pallas", part_size=1024, observe=True),
        device=cuda_device)
    sess.pagerank(num_iterations=3)   # layouts, B1's library
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess.pagerank(num_iterations=3)
        torch.cuda.synchronize()
    kinds = torch.autograd.DeviceType
    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type() == kinds.CPU}
    device = [e.name() for e in events if e.device_type() == kinds.CUDA]
    assert {"repro_torch::" + name for name in (
        "solve", "solve_start", "solve_launch", "solve_readback")} <= host
    assert any("gather_kernel" in name for name in device)
    assert not [name for name in device if "repro_torch" in name]
    sess.obs.close()


def test_one_upload_per_plan_on_the_card(cuda_device, monkeypatch):
    """Two push workers and the stepper reach a released pcpm_pallas
    plan's first use together on the card: its packed streams and "tile"
    gather order are made once."""
    import collections
    import time
    import repro_torch.kernels.pcpm_spmv as b1_pkg
    from repro_torch.core.plan import release_device
    from repro_torch.gateway import Gateway, GatewayConfig
    from repro_torch.serve import SlotScheduler
    g = generators.rmat(11, 8, seed=6)
    sch = SlotScheduler(g, method="pcpm_pallas", part_size=256, chunk=4,
                        slots=4, device=cuda_device)
    release_device(sch.engine.plan)
    counts = collections.Counter()
    for name in ("pack_blocked", "tile_schedule"):
        real = getattr(b1_pkg, name)

        def counted(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            time.sleep(0.05)
            return _real(*a, **kw)

        monkeypatch.setattr(b1_pkg, name, counted)
    work = _gateway_mix(g.num_nodes, 8, seed=7)
    with Gateway(sch, config=GatewayConfig(push_workers=2,
                                           cache_entries=0)) as gw:
        futs = [gw.submit(s, **kw) for s, kw in work]
        res = [f.result(timeout=300) for f in futs]
    assert all(r.error is None and r.converged for r in res)
    assert sch.metrics.counters["push_served"] == 2
    assert counts == {"pack_blocked": 1, "tile_schedule": 1}


def _direct_storm(sch, work, *, threads=6):
    """``work`` submitted from ``threads`` threads straight into ``sch``
    against a free-running device thread (the shape of the reference's
    observed-storm test); returns queries/s."""
    import threading
    import time
    done, errors = threading.Event(), []

    def submitter(part):
        for s, kw in part:
            sch.submit(s, **kw)

    def device_loop():
        try:
            while not done.is_set() or sch.queued or sch.active_slots:
                sch.step()
        except Exception as exc:   # noqa: BLE001
            errors.append(exc)

    t0 = time.perf_counter()
    dev = threading.Thread(target=device_loop)
    dev.start()
    ts = [threading.Thread(target=submitter, args=(work[k::threads],))
          for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    done.set()
    dev.join(timeout=300)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    assert not dev.is_alive() and not errors
    return len(work) / elapsed


def test_observed_storm_qps_within_5pct_on_the_card(cuda_device):
    """Observability on costs < 5% queries/s (the JAX package's bound,
    a timing test held on the card): one scheduler built beforehand, its
    ``obs`` switched off and on between storms in alternating order, 16
    storms a side, each side's queries over the seconds of all its
    storms. The JAX package holds it where chunk compute dominates; on
    the card that takes a graph of 2**20 nodes (at 2**12 a storm is
    bound by the host's Python). Single storms spread by several percent
    on the host and two schedulers built alike can differ for their
    whole lives (``chip_smoke.observability_cost``), so a best of four
    storms over two schedulers reads the spread, not the cost."""
    import gc
    from repro_torch.obs import Observability
    from repro_torch.serve import SlotScheduler
    g = generators.rmat(20, 16, seed=1)
    obs = Observability(capacity=8192)
    sch = SlotScheduler(g, method="pcpm_pallas", part_size=65536, chunk=4,
                        slots=4, obs=obs, device=cuda_device)
    work = _gateway_mix(g.num_nodes, 120, seed=8)
    for state in (None, obs):                         # warm both ways
        sch.obs = state
        _direct_storm(sch, work[:10], threads=2)
    seconds = {"off": 0.0, "on": 0.0}
    recorded = {"off": 0, "on": 0}
    for i in range(16):
        for key in (("off", "on") if i % 2 == 0 else ("on", "off")):
            sch.obs = obs if key == "on" else None
            gc.collect()       # garbage from PRIOR trials is not this
            #                    trial's overhead
            before = obs.recorder.recorded
            seconds[key] += len(work) / _direct_storm(sch, work)
            recorded[key] += obs.recorder.recorded - before
    qps = {key: 16 * len(work) / sec for key, sec in seconds.items()}
    assert sch.trace_count == 1
    assert recorded["off"] == 0 and recorded["on"] > 0
    assert qps["on"] >= 0.95 * qps["off"], qps
    obs.close()


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


# grok-1's GQA group of 6 (48/8 heads; a smaller batch and cache) and a
# windowed "tc" prefill that skips whole key tiles (mixtral's window at a
# smaller scale: 1024 tokens under a 256 window)
B3_NEW_CASES = [
    ((2, 48, 8, 1, 512, 128), None, None), ((1, 12, 2, 320, 320, 128), None,
                                            None),
    ((1, 8, 2, 1024, 1024, 128), 256, None),
    ((1, 32, 8, 1, 1024, 128), None, 700),
]


@pytest.mark.parametrize("shape,window,kv_len", B3_NEW_CASES)
def test_b3_grok_group_and_windowed_tc_vs_plain(cuda_device, shape, window,
                                                kv_len):
    dt = torch.bfloat16
    q, k, v = _attn_inputs(cuda_device, shape, dt, seed=sum(shape))
    decode = shape[3] == 1
    kw = (dict(causal=False, kv_len=torch.full(
        (shape[0],), kv_len or shape[4], dtype=torch.int32,
        device=cuda_device)) if decode else dict(causal=True, window=window))
    path = "split" if decode else "tc"
    before = dict(b3.kernel.launch_counts)
    out = b3.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert b3.kernel.launch_counts == {**before, path: before[path] + 1}
    ref = b3.attention_ref(q.float(), k.float(), v.float(), **kw)
    # a bfloat16 output against float32 sums: its rounding
    torch.testing.assert_close(out.float(), ref, rtol=1.6e-2, atol=2e-3)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "grok-1-314b"])
def test_moe_lm_on_the_card_matches_cpu(cuda_device, arch):
    """The MoE smoke models (grok's with its GQA group of 6) in float32:
    ``forward`` (logits and aux) and ``prefill`` (logits and cache) on the
    card against the port's CPU path, at a capacity that drops routes and
    under a window shorter than the sequence; B3 once per layer a call."""
    smoke = (dict(d_model=192, n_heads=6, n_kv_heads=1)
             if arch == "grok-1-314b" else {})
    cfg = dataclasses.replace(configs.get(arch).scaled(window=32, **smoke),
                              capacity_factor=0.5)
    cpu_model = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 80)))
    before = b3.kernel.launch_count
    logits, aux = tf.forward(gpu_model, tokens.to(cuda_device))
    p_logits, cache = tf.prefill(gpu_model, tokens.to(cuda_device))
    torch.cuda.synchronize()
    assert b3.kernel.launch_count - before == 2 * cfg.n_layers
    ref, ref_aux = tf.forward(cpu_model, tokens)
    ref_p, ref_cache = tf.prefill(cpu_model, tokens)
    tol = dict(rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(logits.cpu(), ref, **tol)
    torch.testing.assert_close(aux.cpu(), ref_aux, rtol=1e-5, atol=0)
    torch.testing.assert_close(p_logits.cpu(), ref_p, **tol)
    for name in ("k", "v"):
        assert cache[name].shape[2] == 32
        torch.testing.assert_close(cache[name].cpu(), ref_cache[name], **tol)


def test_moe_serve_engine_on_the_card_matches_cpu(cuda_device):
    """mixtral's smoke model under an 8-slot window: the decode ring wraps
    in every slot; the card's tokens are the CPU's."""
    cfg = configs.get("mixtral-8x7b").scaled(window=8)
    cpu_model = tf.init_lm(cfg, generator=torch.Generator().manual_seed(1),
                           device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)

    def run(model):
        rng = np.random.default_rng(1)
        reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, int(
            rng.integers(9, 30))).tolist(), max_new_tokens=10)
            for i in range(8)]
        eng = ServeEngine(cfg, model, batch_slots=4, max_len=64)
        return eng, eng.run_until_drained(reqs)

    before = b3.kernel.launch_count
    gpu_eng, on_card = run(gpu_model)
    torch.cuda.synchronize()
    assert b3.kernel.launch_count - before == cfg.n_layers * gpu_eng.steps
    cpu_eng, on_cpu = run(cpu_model)
    assert gpu_eng.steps == cpu_eng.steps
    assert [r.generated for r in on_card] == [r.generated for r in on_cpu]


def test_router_logits_float32_accurate_with_tf32_allowed(cuda_device):
    """A caller that allows TF32 for float32 matmuls does not reach the
    router: its logits on the card are still the float64 product rounded
    to float32, within an ulp of the CPU's."""
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((4, 64, 4096), generator=gen).to(torch.bfloat16)
    router = torch.randn((4096, 8), generator=gen) / 64
    want = (h.double() @ router.double()).float()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        logits, top, _ = tf.route(h.to(cuda_device), router.to(cuda_device),
                                  2)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(top.cpu(), want.topk(2, -1).values,
                               rtol=1e-6, atol=1e-6)


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


# ------------------------------------- B2: lookups and bags bit for bit
def _b2_call(table, ids, *, weights=None, lookup=False):
    """One B2 call (one launch, by the count), held to the plain version:
    equal values everywhere and the same bits wherever a row was read (a
    pad's zeros are +0.0)."""
    before = b2.kernel.launch_count
    if lookup:
        out = b2.embedding_lookup_cuda(table, ids)
        bags = ids.reshape(-1, 1)
    else:
        out = b2.embedding_bag_cuda(table, ids, weights)
        bags = ids
    torch.cuda.synchronize()
    assert b2.kernel.launch_count == before + 1
    want = b2.embedding_bag_ref(table, bags, weights).reshape(out.shape)
    assert torch.equal(out, want)
    bits = torch.int16 if table.dtype == torch.bfloat16 else torch.int32
    read = (bags < table.shape[0]).all(1).reshape(out.shape[:-1])
    if weights is None and bags.shape[1] == 1:
        assert torch.equal(out[read].view(bits), want[read].view(bits))
    return out


B2_LOOKUP_CASES = [  # (V, d, n, dtype)
    (300, 64, 5000, torch.float32),                     # MIND's width
    (200, 512, 3000, torch.bfloat16),                   # graphcast's
    (60, 6272, 500, torch.bfloat16),                    # equiformer-v2's
    (100, 4, 9000, torch.float32),                      # 16-byte rows
    (100, 100, 777, torch.float32),
]


@pytest.mark.parametrize("v,d,n,dtype", B2_LOOKUP_CASES)
def test_b2_lookup_bit_for_bit(cuda_device, v, d, n, dtype):
    rng = np.random.default_rng(v + d + n)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(
        np.float32)).to(cuda_device, dtype)
    ids = torch.from_numpy(rng.integers(-2, v + 3, n)).to(cuda_device)
    ids[0], ids[1] = v, -1                   # a pad, a negative id
    for id_dtype in (torch.int64, torch.int32):
        x = ids.to(id_dtype)
        out = _b2_call(table, x, lookup=True)
        assert not out[0].any() and torch.equal(out[1], table[0])
        _b2_call(table, x.view(-1, 1))
        # ids read through a stride: column 0 of (n, 3)
        wide = torch.stack([x, x + 1, x + 2], 1)
        _b2_call(table, wide[:, :1])
    _b2_call(table, ids[:n - n % 10].view(10, -1).t(), lookup=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_views_and_widths_bit_for_bit(cuda_device, dtype):
    rng = np.random.default_rng(3)
    v, n = 300, 4000
    ids = torch.from_numpy(rng.integers(-2, v + 3, n)).to(cuda_device)
    ids[0], ids[1] = v, -1
    for d in (64, 13, 3, 512):
        base = torch.from_numpy(rng.standard_normal((v, d + 8)).astype(
            np.float32)).to(cuda_device, dtype)
        for table in (base[:, 1:1 + d], base[:, :d].contiguous()):
            for id_dtype in (torch.int64, torch.int32):
                out = _b2_call(table, ids.to(id_dtype), lookup=True)
                assert not out[0].any()
                assert torch.equal(out[1], table[0])
    # weights (a segment-sum's gradient with an edge mask) and L > 1:
    # exact sums (multiples of 1/4 by weights in {0, 1/2, 1}) bit for bit
    table = (torch.from_numpy(rng.integers(-4, 5, (v, 512)) / 4.0)
             .to(cuda_device, dtype))
    mask = torch.from_numpy(rng.integers(0, 3, (n, 1)) / 2.0).float().to(
        cuda_device)
    _b2_call(table, ids[:, None], weights=mask)
    bags = ids.view(-1, 8)
    _b2_call(table, bags)
    _b2_call(table, bags.int(), weights=mask.view(-1, 8))


def test_b2_persistent_grid_strides_over_many_bags(cuda_device):
    """More bags than the resident blocks hold: the blocks stride over
    them (13,107,200 one-id bags, MIND's serve_bulk count), at 16-byte
    and at 24-byte rows."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((1000, 8)).astype(
        np.float32)).to(cuda_device)
    ids = torch.randint(-1, 1002, (13_107_200,), device=cuda_device)
    _b2_call(table[:, :4].contiguous(), ids, lookup=True)
    _b2_call(table[:, :6], ids, lookup=True)


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


# -------------------------------------------------------- kernel B2-bwd
def _b2_bwd_exact(dev, b, l, v, d, seed, *, hot=None, weighted=True):
    """dout in multiples of 1/16, weights in multiples of 1/4: the sums
    are exact in float32 in any order."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-2, v + 3, (b, l))
    if hot is not None:
        idx[rng.random((b, l)) < 0.6] = hot
    dout = rng.integers(-16, 17, (b, d)).astype(np.float32) / 16
    w = rng.integers(0, 5, (b, l)).astype(np.float32) / 4
    return (torch.from_numpy(dout).to(dev), torch.from_numpy(idx).to(dev),
            torch.from_numpy(w).to(dev) if weighted else None)


def _b2_bwd(dout, idx, w, v):
    before = b2.kernel.bwd_launch_count
    grad = b2.embedding_bag_bwd_cuda(dout, idx, w, v)
    torch.cuda.synchronize()
    assert b2.kernel.bwd_launch_count == before + 1
    assert grad.dtype == dout.dtype and grad.shape == (v, dout.shape[1])
    return grad


@pytest.mark.parametrize("v,d,b,l", B2_SHAPES)
def test_b2_bwd_exact_sums_and_emulation_bits(cuda_device, v, d, b, l):
    dout, idx, w = _b2_bwd_exact(cuda_device, b, l, v, d, v + d, hot=5)
    grad = _b2_bwd(dout, idx, w, v)
    assert torch.equal(grad, b2.embedding_bag_bwd_ref(dout, idx, w, v))
    assert torch.equal(grad, _b2_bwd(dout, idx, w, v))
    # random float32: the kernel's bits are its CPU emulation's
    rng = np.random.default_rng(d)
    noisy = torch.from_numpy(rng.standard_normal(dout.shape).astype(
        np.float32)).to(cuda_device)
    wr = torch.rand(idx.shape, device=cuda_device)
    grad = _b2_bwd(noisy, idx, wr, v)
    torch.testing.assert_close(grad, b2.embedding_bag_bwd_ref(noisy, idx, wr,
                                                              v),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(grad.cpu(), b2.embedding_bag_bwd_emulate(
        noisy.cpu(), idx.cpu(), wr.cpu(), v, b2.kernel.BWD_CHUNK))
    assert torch.equal(grad, _b2_bwd(noisy, idx, wr, v))


@pytest.mark.parametrize("d", [64, 6, 13, 1030])
def test_b2_bwd_pads_negatives_and_bf16(cuda_device, d):
    v = 300
    dout, idx, _ = _b2_bwd_exact(cuda_device, 40, 5, v, d, d,
                                 weighted=False)
    idx[0] = v                                          # a bag of pads
    idx[1, 0] = -1                                      # to row 0
    grad = _b2_bwd(dout, idx, None, v)
    assert torch.equal(grad, b2.embedding_bag_bwd_ref(dout, idx, None, v))
    assert grad[0].abs().sum() > 0
    bf = _b2_bwd(dout.bfloat16(), idx, None, v)
    torch.testing.assert_close(bf.float(), grad, rtol=2 ** -7, atol=1e-5)
    assert torch.equal(bf.cpu(), b2.embedding_bag_bwd_emulate(
        dout.bfloat16().cpu(), idx.cpu(), None, v, b2.kernel.BWD_CHUNK))


def test_b2_bwd_hot_row_and_empty(cuda_device):
    n, v, d = 120_000, 1000, 64
    rng = np.random.default_rng(1)
    ids = np.where(rng.random(n) < 0.8, 7, rng.integers(0, v + 2, n))
    idx = torch.from_numpy(ids.reshape(n, 1)).to(cuda_device)
    dout = torch.from_numpy(rng.integers(-16, 17, (n, d)).astype(np.float32)
                            / 16).to(cuda_device)
    grad = _b2_bwd(dout, idx, None, v)
    assert torch.equal(grad, b2.embedding_bag_bwd_ref(dout, idx, None, v))
    # random values: float32 sums of ~96k terms differ by ~1e-2 between
    # orders, so the kernel is held to its CPU emulation's bits
    noisy = torch.randn((n, d), device=cuda_device)
    grad = _b2_bwd(noisy, idx, None, v)
    assert torch.equal(grad.cpu(), b2.embedding_bag_bwd_emulate(
        noisy.cpu(), idx.cpu(), None, v, b2.kernel.BWD_CHUNK))
    assert torch.equal(grad, _b2_bwd(noisy, idx, None, v))
    pads = torch.full((3, 2), v, device=cuda_device)
    assert not _b2_bwd(torch.ones((3, d), device=cuda_device), pads, None,
                       v).any()


def test_b2_bwd_wide_slabs_emulation_bits(cuda_device):
    """B2-bwd at equiformer-v2's width (d 6272 bfloat16: 25 slabs), mask
    weights, a hot row across chunks: the emulation's bits, each call's
    walk "cp.async" (by the per-form counts), and a second call
    bit-identical."""
    rng = np.random.default_rng(27)
    e, v, d = 3000, 400, 6272
    ids = rng.integers(-1, v + 2, e)
    ids[rng.random(e) < 0.3] = 7
    idx = torch.from_numpy(ids).view(-1, 1).to(cuda_device)
    dout = torch.randn((e, d), device=cuda_device).bfloat16()
    mask = torch.from_numpy(rng.integers(0, 3, (e, 1)) / 2.0).float().to(
        cuda_device)
    for w in (mask, None):
        before = dict(b2.kernel.bwd_launch_counts)
        grad = _b2_bwd(dout, idx, w, v)
        assert b2.kernel.bwd_launch_counts == {
            **before, "cp.async": before["cp.async"] + 1}
        assert torch.equal(grad, _b2_bwd(dout, idx, w, v))
        assert torch.equal(grad.cpu(), b2.embedding_bag_bwd_emulate(
            dout.cpu(), idx.cpu(), None if w is None else w.cpu(), v,
            b2.kernel.BWD_CHUNK))


def test_mind_train_step_on_the_card_matches_cpu(cuda_device, monkeypatch):
    from repro_torch.optim import AdamW
    monkeypatch.setattr(recsys, "LOSS_BLOCK_ROWS", 16)    # 4 blocks of 64
    cfg = configs.get("mind").scaled()
    cpu_model = recsys.init_mind(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    rng = np.random.default_rng(0)
    hist = rng.integers(0, cfg.vocab, (64, cfg.hist_len)).astype(np.int32)
    hist[:, -3:] = cfg.vocab
    hist[0, 0] = -1
    batch = {"hist": torch.from_numpy(hist),
             "target": torch.from_numpy(rng.integers(0, cfg.vocab, 64)
                                        .astype(np.int32))}
    gpu_batch = {k: t.to(cuda_device) for k, t in batch.items()}

    def table_grad(model, b):
        with model.trainable():
            loss = recsys.mind_loss(model, cfg, b)
            return torch.autograd.grad(loss, model.table)[0]
    before = (b2.kernel.launch_count, b2.kernel.bwd_launch_count)
    g = table_grad(gpu_model, gpu_batch)
    torch.cuda.synchronize()
    assert (b2.kernel.launch_count, b2.kernel.bwd_launch_count) == (
        before[0] + 1, before[1] + 1)
    want = table_grad(cpu_model, batch)
    assert g.abs().sum() > 0
    torch.testing.assert_close(g.cpu(), want, rtol=1e-4, atol=1e-6)
    opt = AdamW(lr=1e-2)
    states = [opt.init(m) for m in (cpu_model, gpu_model)]
    step = recsys.make_train_step(cfg, opt)
    for _ in range(3):
        _, states[0], m_cpu = step(cpu_model, states[0], batch)
        _, states[1], m_gpu = step(gpu_model, states[1], gpu_batch)
        torch.testing.assert_close(m_gpu["loss"].cpu(), m_cpu["loss"],
                                   rtol=1e-5, atol=1e-6)
    for name in recsys.PARAM_NAMES:
        torch.testing.assert_close(getattr(gpu_model, name).cpu(),
                                   getattr(cpu_model, name), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------- the GNNs (A11.4)
def test_segment_sum_on_the_card(cuda_device):
    """``segment_sum``: B2-bwd forward, B2 backward, one launch each;
    exact sums bit-equal to the CPU path, out-of-range ids dropped,
    random float32 and bfloat16 within each element's summation bound,
    two calls with the same bits."""
    rng = np.random.default_rng(0)
    e, n, d = 5000, 300, 72
    values = torch.from_numpy(rng.integers(-16, 17, (e, 3, d // 3))
                              / 16.0).float()
    seg = torch.from_numpy(rng.integers(-3, n + 3, e).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, 5, e) / 4.0).float()
    want = b2.segment_sum(values, seg, n, w)
    v_dev = values.to(cuda_device).requires_grad_(True)
    before = (b2.kernel.launch_count, b2.kernel.bwd_launch_count)
    out = b2.segment_sum(v_dev, seg.to(cuda_device), n, w.to(cuda_device))
    gout = torch.from_numpy(rng.integers(-8, 9, (n, 3, d // 3)) / 8.0).float()
    g, = torch.autograd.grad(out, v_dev, gout.to(cuda_device))
    torch.cuda.synchronize()
    assert (b2.kernel.launch_count, b2.kernel.bwd_launch_count) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(out.detach().cpu(), want)
    v_cpu = values.clone().requires_grad_(True)
    g_cpu, = torch.autograd.grad(b2.segment_sum(v_cpu, seg, n, w), v_cpu,
                                 gout)
    assert torch.equal(g.cpu(), g_cpu)
    assert not g.cpu()[(seg < 0) | (seg >= n)].any()
    # random values, float32 and bfloat16: within each element's bound
    # against the CPU path on the same inputs (two float32 orders of a
    # row's n terms, 2 n u sum |terms|, and two roundings to bfloat16)
    noisy = torch.randn((e, d), device=cuda_device)
    ids = seg.to(cuda_device)
    kept = seg[(seg >= 0) & (seg < n)].long()
    count = torch.bincount(kept, minlength=n)[:, None]
    for x, rounding in ((noisy, 0.0), (noisy.bfloat16(), 2.0 ** -7)):
        got = b2.segment_sum(x, ids, n)
        assert got.dtype == x.dtype
        assert torch.equal(got, b2.segment_sum(x, ids, n))
        want = b2.segment_sum(x.cpu(), seg, n).float()
        absum = b2.segment_sum(x.cpu().float().abs(), seg, n)
        bound = (2 * count * 2.0 ** -24 + rounding) * absum
        assert ((got.cpu().float() - want).abs() <= bound).all()


GNN_CARD_ARCHS = ["graphcast", "nequip", "mace", "equiformer-v2"]


@pytest.mark.parametrize("arch", GNN_CARD_ARCHS)
def test_gnn_train_step_on_the_card_matches_cpu(cuda_device, arch):
    """A smoke GNN's gradients and two train steps on the card against
    the CPU path on the same parameters (float32 without TF32; the card
    sums in other orders), B2 and B2-bwd launched as ``kernel_calls``
    counts, and a step repeated from the same state bit for bit."""
    from repro_torch.models import gnn
    from repro_torch.optim import AdamW
    cfg = configs.get(arch).scaled()
    cpu_model = gnn.init_gnn(cfg, 12, 8, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    g = gnn.random_graph_batch(np.random.default_rng(0), 40, 160, 12,
                               device="cpu")
    g_dev = g.to(cuda_device)

    def grads(model, batch):
        names, tensors = zip(*model.named_parameters())
        with model.trainable():
            loss = gnn.gnn_loss(model, cfg, batch, n_out=8)
            gs = torch.autograd.grad(loss, tensors, allow_unused=True,
                                     materialize_grads=True)
        return loss.detach(), dict(zip(names, gs))
    loss_c, grads_c = grads(cpu_model, g)
    loss_g, grads_g = grads(gpu_model, g_dev)
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=1e-6)
    total = float(torch.sqrt(sum(x.square().sum() for x in grads_c.values())))
    zero = gnn.ZERO_GRADIENT_LEAVES.get(arch, ())
    for name, x in grads_c.items():
        if zero and name.endswith(zero):      # rounding noise on both sides
            assert float(grads_g[name].norm()) <= 1e-8 * total, name
            assert float(x.norm()) <= 1e-8 * total, name
            continue
        gap = float((grads_g[name].cpu() - x).norm())
        assert gap <= 1e-4 * max(float(x.norm()), 1e-6 * total), name
    opt = AdamW(lr=1e-3)
    step = gnn.make_gnn_train_step(cfg, opt, n_out=8)
    states = [opt.init(m) for m in (cpu_model, gpu_model)]
    for _ in range(2):
        _, states[0], m_cpu = step(cpu_model, states[0], g)
        before = (b2.kernel.launch_count, b2.kernel.bwd_launch_count)
        _, states[1], m_gpu = step(gpu_model, states[1], g_dev)
        torch.cuda.synchronize()
        want = gnn.kernel_calls(cfg, 160)
        assert (b2.kernel.launch_count - before[0],
                b2.kernel.bwd_launch_count - before[1]) == (
            want["B2"], want["B2-bwd"])
        torch.testing.assert_close(m_gpu["loss"].cpu(), m_cpu["loss"],
                                   rtol=1e-5, atol=1e-6)
    saved = copy.deepcopy(gpu_model), copy.deepcopy(states[1])
    _, _, m1 = step(gpu_model, states[1], g_dev)
    first = [p.detach().clone() for p in gpu_model.parameters()]
    model2, state2 = saved
    _, _, m2 = step(model2, state2, g_dev)
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(first, model2.parameters()))


# ------------------------------------------------- the sharded path (A10)
@pytest.fixture
def nccl_group(cuda_device):
    """A one-rank NCCL process group on the card, torn down after the
    test."""
    import datetime
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(cuda_device.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        assert dist.get_backend() == "nccl"
        yield cuda_device
    finally:
        dist.destroy_process_group()


def test_sharded_pagerank_and_spmv_through_nccl(nccl_group):
    from repro_torch.core import SpMVEngine, pagerank
    dev = nccl_group
    g = generators.rmat(10, 8, seed=4)
    eng = SpMVEngine(g, method="pcpm_sharded", device=dev)
    mesh = eng.mesh
    assert mesh.group is not None and mesh.num_shards == 1
    res = pagerank(g, engine=eng, num_iterations=20)
    assert mesh.counts["all_to_all_single"] == 20
    assert "identity_all_to_all" not in mesh.counts
    cpu = pagerank(g, method="pcpm", num_iterations=20, device="cpu")
    assert np.abs(res.ranks.cpu().numpy() - cpu.ranks.numpy()).max() <= 1e-6
    x = (np.random.default_rng(0).integers(0, 16, (g.num_nodes, 4))
         / 16).astype(np.float32)
    np.testing.assert_allclose(eng(x).cpu().numpy(),
                               dense_spmv(g.num_nodes, g.src, g.dst, x),
                               rtol=1e-5, atol=1e-6)
    res_t = pagerank(g, engine=eng, num_iterations=200, tol=1e-6)
    # the CPU side runs unsharded: the group's NCCL takes no CPU tensor
    cpu_t = pagerank(g, method="pcpm", num_iterations=200, tol=1e-6,
                     device="cpu")
    assert abs(res_t.iterations - cpu_t.iterations) <= 1
    assert np.abs(res_t.ranks.cpu().numpy()
                  - cpu_t.ranks.numpy()).max() <= 1e-6


def test_sharded_solve_stays_off_the_graph_path(nccl_group):
    """A ``tol == 0`` solve on the sharding backend runs the distributed
    loop of ``core/distributed.py``: one all-to-all an iteration, nothing
    captured or replayed."""
    import importlib
    from repro_torch.core import SpMVEngine, pagerank
    solver = importlib.import_module("repro_torch.core.pagerank")
    g = generators.rmat(10, 8, seed=4)
    eng = SpMVEngine(g, method="pcpm_sharded", device=nccl_group)
    counts = solver.graph_captures, solver.graph_replays
    for _ in range(2):
        pagerank(g, engine=eng, num_iterations=5)
    assert eng.mesh.counts["all_to_all_single"] == 10
    assert (solver.graph_captures, solver.graph_replays) == counts


def test_sharded_scheduler_and_server_through_nccl(nccl_group):
    from repro_torch.serve import PageRankServer, SlotScheduler
    dev = nccl_group
    g = generators.rmat(10, 8, seed=4)
    seeds = np.zeros(g.num_nodes, np.float32)
    seeds[[3, 70]] = 1.0
    out = []
    # the CPU side runs unsharded: the group's NCCL takes no CPU tensor
    for kw in (dict(sharded=True, device=dev),
               dict(method="pcpm", route="stepper", device="cpu")):
        sch = SlotScheduler(g, slots=3, chunk=4, **kw)
        uids = [sch.submit(tol=0.0, max_iters=15),
                sch.submit(seeds, tol=1e-6, max_iters=200),
                sch.submit(seeds, tol=0.0, max_iters=12, top_k=8)]
        by = {q.uid: q for q in sch.run_until_drained()}
        out.append([by[u] for u in uids])
        assert sch.trace_count == 1
    card, cpu = out
    assert np.abs(card[0].ranks - cpu[0].ranks).max() <= 1e-6
    assert abs(card[1].iterations - cpu[1].iterations) <= 1
    assert np.abs(card[1].ranks - cpu[1].ranks).max() <= 1e-6
    assert np.array_equal(card[2].top_ids, cpu[2].top_ids)
    srv = PageRankServer(g, sharded=True, num_iterations=10, batch=2,
                         device=dev)
    pr, it, _ = srv.query(np.stack([seeds, np.ones_like(seeds)], 1))
    ref = PageRankServer(g, method="pcpm", num_iterations=10, batch=2,
                         device="cpu").query(
        np.stack([seeds, np.ones_like(seeds)], 1))[0]
    assert it == 10
    assert np.abs(pr.cpu().numpy() - ref.numpy()).max() <= 1e-6


def test_gnn_dist_through_nccl(nccl_group):
    """Part (a) of ``chip_smoke.py``'s phase 16 at the smoke size: the
    PCPM-distributed GraphCast (float32) in a one-rank NCCL group against
    ``graphcast_forward`` and ``gnn_loss`` on the same edges in the
    layout's order, so each destination sums its edges in one order; the
    forward within the reference test's rtol 2e-4 / atol 2e-5, each
    gradient leaf within 1e-4, and the launches and collectives of a
    train step as ``dist_kernel_calls`` and ``dist_collective_calls``
    count them."""
    from repro_torch.core.distributed import build_mesh, build_sharded_png
    from repro_torch.models import gnn, gnn_dist
    from repro_torch.optim import AdamW
    dev = nccl_group
    cfg = configs.get("graphcast").scaled()
    g = generators.rmat(9, 8, seed=5)
    n = g.num_nodes
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((n, 12)).astype(np.float32)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    labels = rng.integers(0, 8, n).astype(np.int32)
    layout = build_sharded_png(g, 1)
    mesh = build_mesh(1, device=dev)
    dg = gnn_dist.DistGraph.from_png(layout, feat, pos, labels, mesh=mesh)
    src = layout.send_ids[0, 0][layout.edge_upd[0]]
    e = src.shape[0]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    gb = gnn.GraphBatch(put(src), put(layout.edge_dst[0]),
                        torch.ones(e, device=dev), put(feat), put(pos),
                        torch.ones(n, device=dev),
                        torch.zeros(n, dtype=torch.int32, device=dev), 1,
                        put(labels))
    model = gnn.init_gnn(cfg, 12, 8, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        got = gnn_dist.graphcast_dist_forward(model, cfg, dg, mesh)
        want = gnn.graphcast_forward(model.tree, cfg, gb)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    names, tensors = zip(*model.named_parameters())
    with model.trainable():
        loss = gnn.gnn_loss(model, cfg, gb, n_out=8)
        grads = dict(zip(names, torch.autograd.grad(loss, tensors)))
    loss_d, grads_d = gnn_dist.dist_loss_and_grads(model, cfg, dg, mesh)
    torch.testing.assert_close(loss_d, loss.detach(), rtol=1e-4, atol=0)
    total = float(torch.sqrt(sum(x.square().sum() for x in grads.values())))
    for name, x in grads.items():
        gap = float((grads_d[name] - x).norm())
        assert gap <= 1e-4 * max(float(x.norm()), 1e-6 * total), name
    opt = AdamW(lr=1e-3)
    step = gnn_dist.make_dist_train_step(cfg, opt, mesh, n_out=8)
    mesh.counts.clear()
    before = (b2.kernel.launch_count, b2.kernel.bwd_launch_count)
    _, _, metrics = step(model, opt.init(model), dg)
    torch.cuda.synchronize()
    calls = gnn_dist.dist_kernel_calls(cfg)
    assert (b2.kernel.launch_count - before[0],
            b2.kernel.bwd_launch_count - before[1]) == (calls["B2"],
                                                        calls["B2-bwd"])
    assert dict(mesh.counts) == {
        k: v for k, v in gnn_dist.dist_collective_calls(cfg).items() if v}
    assert bool(torch.isfinite(metrics["loss"]))


# ------------------------------------------------------- B3-bwd, training
def _b3_bwd_tol(dtype, ref):
    """float32: 2e-3 (sums in another order); bfloat16: the outputs'
    rounding (2**-7 relative on each element, 1.6e-2 of the tensor's
    largest magnitude for elements near 0; inside TestFlashAttention's
    5e-2)."""
    if dtype == torch.float32:
        return dict(rtol=2e-3, atol=2e-3)
    return dict(rtol=1.6e-2, atol=1.6e-2 * float(ref.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,window", B3_CASES)
def test_b3_bwd_vs_plain(cuda_device, shape, window, dtype):
    """B3-bwd at TestFlashAttention's shapes and windows (and Sq < Skv)
    against autograd through the plain version on the same inputs upcast
    to float32, through the path its dtype names ("tc" for bfloat16,
    "simt" for float32); the forward with its log-sum-exp gives the same
    output bits as without it."""
    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(cuda_device, shape, dt, seed=sum(shape) + 1)
    do = torch.randn(q.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(2), device=cuda_device).to(dt)
    kw = dict(causal=True, window=window)
    plain_out = b3.flash_attention_cuda(q, k, v, **kw)
    out, lse, o32 = b3.flash_attention_cuda(q, k, v, for_backward=True, **kw)
    path = "tc" if dt == torch.bfloat16 else "simt"
    before = b3.kernel.bwd_launch_count
    counts = dict(b3.kernel.bwd_launch_counts)
    grads = b3.flash_attention_bwd_cuda(q, k, v, o32, lse, do, **kw)
    torch.cuda.synchronize()
    assert b3.kernel.bwd_launch_count == before + 1
    assert b3.kernel.bwd_launch_counts == {**counts, path: counts[path] + 1}
    assert torch.equal(out, plain_out)
    assert o32.dtype == torch.float32 and torch.equal(o32.to(dt), out)
    torch.testing.assert_close(lse, b3.lse_ref(q.float(), k.float(), **kw),
                               rtol=1e-4, atol=1e-4)
    want = b3.attention_bwd_ref(q.float(), k.float(), v.float(), do.float(),
                                **kw)
    for name, g, w, x in zip("qkv", grads, want, (q, k, v)):
        assert g.dtype == dt and g.shape == x.shape
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w, **_b3_bwd_tol(dt, w),
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("d", [32, 64, 128])
def test_b3_bwd_kv_len_and_views(cuda_device, d):
    """An int kv_len and strided views of q, k and v (the model's fused
    layouts); dO non-contiguous."""
    base = torch.randn((2, 96, 3, 4, d), device=cuda_device)
    q = base[:, :, 0]                                  # (2, 96, 4, d) view
    k, v = base[:, :, 1, :2], base[:, :, 2, 2:]
    do = torch.randn((2, 4, 96, d), device=cuda_device).transpose(1, 2)
    _, lse, o32 = b3.flash_attention_cuda(q, k, v, causal=False, kv_len=70,
                                          for_backward=True)
    grads = b3.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=False,
                                        kv_len=70)
    want = b3.attention_bwd_ref(q, k, v, do, causal=False, kv_len=70)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-3)
    assert float(grads[1][:, 70:].abs().max()) == 0.0


def test_b3_bwd_tc_is_deterministic(cuda_device):
    """Two "tc" calls on the same inputs give the same bits (every output
    row summed by one block in a fixed order; no atomics), at a shape
    whose blocks outnumber the card's SMs."""
    q, k, v = _attn_inputs(cuda_device, (2, 16, 4, 1024, 1024, 64),
                           torch.bfloat16, seed=7)
    do = torch.randn(q.shape, device=cuda_device).to(torch.bfloat16)
    _, lse, o32 = b3.flash_attention_cuda(q, k, v, for_backward=True)
    first = b3.flash_attention_bwd_cuda(q, k, v, o32, lse, do)
    second = b3.flash_attention_bwd_cuda(q, k, v, o32, lse, do)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_b3_bwd_tc_kv_len_and_unaligned_views(cuda_device, d):
    """"tc" on views whose rows are not 16-byte aligned (loaded element by
    element), an int kv_len (keys past it get zeros) and Sq < Skv."""
    def view(b, s, h, seed):
        base = torch.randn((b, s, h, d + 1), generator=torch.Generator(
            device=cuda_device).manual_seed(seed), device=cuda_device)
        return base.to(torch.bfloat16)[..., 1:]
    q, do = view(2, 80, 4, 1), view(2, 80, 4, 2)
    k, v = view(2, 144, 2, 3), view(2, 144, 2, 4)
    _, lse, o32 = b3.flash_attention_cuda(q, k, v, kv_len=100,
                                          for_backward=True)
    grads = b3.flash_attention_bwd_cuda(q, k, v, o32, lse, do, kv_len=100)
    want = b3.attention_bwd_ref(q.float(), k.float(), v.float(), do.float(),
                                kv_len=100)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.float(), w,
                                   **_b3_bwd_tol(torch.bfloat16, w))
    assert float(grads[1][:, 100:].abs().max()) == 0.0
    assert float(grads[2][:, 100:].abs().max()) == 0.0


def test_b3_bwd_rejects_what_it_cannot_take(cuda_device):
    q, k, v = _attn_inputs(cuda_device, (1, 4, 2, 64, 64, 64), torch.float32,
                           seed=0)
    out, lse, _ = b3.flash_attention_cuda(q, k, v, for_backward=True)
    with pytest.raises(NotImplementedError):
        b3.flash_attention_bwd_cuda(q, k, v, out, lse, out,
                                    kv_len=torch.tensor([3], device=q.device))
    with pytest.raises(TypeError):
        b3.flash_attention_bwd_cuda(q, k, v, out, lse, out.bfloat16())
    with pytest.raises(TypeError):
        b3.flash_attention_bwd_cuda(*(x.bfloat16() for x in (q, k, v)),
                                    out.bfloat16(), lse, out.bfloat16())
    with pytest.raises(ValueError):
        b3.flash_attention_bwd_cuda(q, k, v, out, lse[:, :, 1:], out)
    with pytest.raises(ValueError, match="Sq > 1"):
        b3.flash_attention_cuda(q[:, :1], k, v, causal=False,
                                for_backward=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_autograd_reaches_q_k_v(cuda_device, dtype):
    """``attention`` with inputs that require a gradient runs B3 with its
    log-sum-exp and B3-bwd in the backward, once each; without, it is the
    plain forward launch and builds no graph."""
    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(cuda_device, (2, 8, 2, 200, 200, 64), dt, seed=5)
    do = torch.randn(q.shape, device=cuda_device).to(dt)
    with torch.no_grad():
        before = (b3.kernel.launch_count, b3.kernel.bwd_launch_count)
        plain = b3.attention(q, k, v, causal=True)
        assert plain.grad_fn is None
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = b3.attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (b3.kernel.launch_count, b3.kernel.bwd_launch_count) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(out.detach(), plain)
    want = b3.attention_bwd_ref(q.float(), k.float(), v.float(), do.float(),
                                causal=True)
    for g, w in zip(grads, want):
        assert float(g.float().abs().max()) > 0
        torch.testing.assert_close(g.float(), w, **_b3_bwd_tol(dt, w))


class _Recording:
    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def update(self, grads, state, params):
        self.grads = grads
        return self.opt.update(grads, state, params)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b"])
@pytest.mark.parametrize("nm", [1, 2])
def test_train_step_on_the_card_matches_cpu(cuda_device, arch, nm):
    """A float32 train step of the smoke model on the card (B3 "simt"
    with its log-sum-exp, B3-bwd once per layer and microbatch) against
    the same step on the CPU: metrics within 1e-4 relative, every
    gradient within 1e-3 of its largest magnitude (float32 sums in other
    orders, through 2 layers)."""
    from repro_torch.optim import AdamW
    cfg = configs.get(arch).scaled()
    cpu_model = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 64)))
    labels = torch.roll(tokens, -1, 1)

    def step(model, dev):
        opt = _Recording(AdamW(lr=1e-3))
        run = tf.make_train_step(cfg, opt, num_microbatches=nm)
        return run(model, opt.opt.init(model), {
            "tokens": tokens.to(dev), "labels": labels.to(dev)})[2], opt

    before = b3.kernel.bwd_launch_count
    m_gpu, opt_gpu = step(gpu_model, cuda_device)
    torch.cuda.synchronize()
    assert b3.kernel.bwd_launch_count - before == cfg.n_layers * nm
    m_cpu, opt_cpu = step(cpu_model, "cpu")
    for key in ("loss", "nll", "aux", "gnorm"):
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], rtol=1e-4,
                                   atol=1e-6)
    for name, g in opt_gpu.grads.items():
        want = opt_cpu.grads[name]
        assert float(g.abs().max()) > 0, name
        torch.testing.assert_close(g.cpu(), want, rtol=1e-3,
                                   atol=1e-3 * float(want.abs().max()),
                                   msg=lambda m: f"{name}: {m}")


def test_resume_on_the_card_is_bit_identical(cuda_device, tmp_path):
    """The restart drill on the card: bfloat16 smoke model, 10 steps,
    checkpoints every 5, a failure at step 7, resumed from step 5; the
    final parameters and moments equal the uninterrupted run's bit for
    bit (B3-bwd and every other kernel of the step sum in a fixed
    order)."""
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.optim import AdamW
    from repro_torch.train import Trainer, TrainerConfig
    cfg = configs.get("tinyllama-1.1b").scaled()

    def setup(path, fail_at=None, start=0):
        model = tf.init_lm(cfg, generator=torch.Generator(
            device=cuda_device).manual_seed(0), device=cuda_device)
        opt = AdamW(lr=1e-3)

        def hook(s):
            if s == fail_at:
                raise RuntimeError("injected node failure")
        return Trainer(
            TrainerConfig(total_steps=10, checkpoint_every=5,
                          ckpt_dir=str(path), log_every=1000),
            tf.make_train_step(cfg, opt, num_microbatches=2),
            (model, opt.init(model)),
            synthetic_lm_batches(cfg.vocab, 4, 64, seed=3, start_step=start,
                                 device=cuda_device),
            failure_hook=hook if fail_at is not None else None,
            log_fn=lambda *a: None)

    a = setup(tmp_path / "a")
    a.run()
    with pytest.raises(RuntimeError):
        setup(tmp_path / "b", fail_at=7).run()
    c = setup(tmp_path / "b", start=5)
    assert c.try_resume() and c.step == 5
    c.run()
    for (n, x), (_, y) in zip(a.state[0].named_parameters(),
                              c.state[0].named_parameters()):
        assert x.device.type == "cuda" and torch.equal(x, y), n
    for n in a.state[1].mu:
        assert torch.equal(a.state[1].mu[n], c.state[1].mu[n]), n
        assert torch.equal(a.state[1].nu[n], c.state[1].nu[n]), n
