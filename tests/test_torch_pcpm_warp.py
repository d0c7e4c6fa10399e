"""Kernel B1's "warp" path on the CPU: a torch emulation of the CUDA
source's loop (lane groups across the row, ranges taken in rounds, run
sums flushed at destination changes and at range ends) against the plain
version, in both row forms (bins, and x through ``update_src``); the
geometry a launch is given; the fused plain version ``pcpm_spmv_ref``
against the JAX package's ``ops.pcpm_spmv_pallas`` (interpret mode); and
``pcpm_spmv_pallas`` routing the "warp" gather through the fused form,
with no bins.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro_torch.core import Partitioning, block_png, build_png
from repro_torch.graphs import formats, generators
from repro_torch.kernels.pcpm_spmv import (kernel, ops, pack_blocked,
                                           pcpm_gather_ref, pcpm_spmv_cuda,
                                           pcpm_spmv_pallas, pcpm_spmv_ref)
from repro_torch.kernels.pcpm_spmv.kernel import WarpGeometry

from test_torch_reference import dense_spmv, load_reference

ref_gen = load_reference("graphs.generators")
ref_core = load_reference("core")
ref_ops = load_reference("kernels.pcpm_spmv.ops")

WIDTHS = [1, 2, 3, 16, 17, 40]
ORDERS = ["dst-sorted", "shuffled", "reversed"]
# paper fig. 3a (tests/test_core_pcpm.py PAPER_EDGES): 9 nodes
PAPER_EDGES = np.array([
    [6, 2], [7, 0], [7, 1], [7, 2],
    [3, 4], [6, 3], [6, 4], [6, 5],
    [2, 8], [7, 8],
], dtype=np.int32)


def emulate_warp_loop(rows: torch.Tensor, edge_upd: torch.Tensor,
                      edge_dst: torch.Tensor, part_size: int,
                      geometry: WarpGeometry, update_src=None):
    """B1's "warp" path as the CUDA source runs it. The streams are one
    flat stream of k·E slots (E = n_eb·Eb; a slot's partition is
    slot // E). For each column tile of ``lanes · vec`` columns, group g
    of ``geometry.groups`` takes slots [g·range + i·window, ... + range)
    in round i (window = groups · range); it fetches 4·lanes slots at a
    time (lane l its four slots 4l .. 4l + 3, the slots past the range's
    end read as pads), turns each into a key (partition·P + destination,
    -1 for a pad) and a row (of bins, or of x through ``update_src``; an
    entry outside [0, n) makes a pad), and walks them in slot order: a
    pad is skipped, a key equal to the run's adds its row into the run's
    sum, another key flushes the run into the output and starts a new
    one; the range's last run is flushed at its end. Asserts that every
    slot is read once per column tile. Returns the output in ``rows``'
    dtype and the list of flushes (key, group)."""
    k, n_eb, eb = edge_upd.shape
    e_part = n_eb * eb
    slots = k * e_part
    d = rows.shape[-1]
    fused = update_src is not None
    n_upd = update_src.shape[1] if fused else rows.shape[1]
    n_rows = rows.shape[0] if fused else 0
    lanes, vec, rng = geometry.lanes, geometry.vec, geometry.range
    fetch = 4 * lanes
    assert rng % fetch == 0 and geometry.groups * lanes == (
        geometry.blocks * kernel.WARP_THREADS)
    table = rows.float().reshape(-1, d).numpy()
    eu = edge_upd.reshape(-1).numpy()
    ed = edge_dst.reshape(-1).numpy()
    usrc = update_src.reshape(-1).numpy() if fused else None
    acc = np.zeros((k * part_size, d), np.float32)
    flushes = []
    window = geometry.groups * rng
    for c0 in range(0, d, lanes * vec):
        cols = np.arange(c0, min(c0 + lanes * vec, d))
        taken = np.zeros(slots, np.int64)
        for g in range(geometry.groups):
            for r0 in range(g * rng, slots, window):
                r1 = min(r0 + rng, slots)
                cur, run = -1, None
                for s0 in range(r0, r1, fetch):
                    keys, rws = [], []
                    for lane in range(lanes):
                        s = s0 + 4 * lane
                        p = s // e_part
                        p_end = (p + 1) * e_part
                        for c in range(4):
                            while s + c >= p_end:
                                p, p_end = p + 1, p_end + e_part
                            u, j = n_upd, part_size
                            if s + c < r1:
                                u, j = int(eu[s + c]), int(ed[s + c])
                                taken[s + c] += 1
                            ok = 0 <= u < n_upd and 0 <= j < part_size
                            r = p * n_upd + u if ok else 0
                            if fused and ok:
                                r = int(usrc[r])
                                ok = 0 <= r < n_rows
                            keys.append(p * part_size + j if ok else -1)
                            rws.append(r)
                    for key, r in zip(keys, rws):  # slot order: t = 4l + c
                        if key < 0:
                            continue
                        v = table[r, cols]
                        if key != cur:
                            if cur >= 0:
                                acc[cur, cols] += run
                                flushes.append((cur, g))
                            cur, run = key, v.copy()
                        else:
                            run += v
                if cur >= 0:
                    acc[cur, cols] += run
                    flushes.append((cur, g))
        assert (taken == 1).all()
    out = torch.from_numpy(acc).view(k, part_size, d)
    return out.to(rows.dtype), flushes


def crossings(flushes, geometry: WarpGeometry) -> set[str]:
    """Which edges the runs of a key crossed: the ranges of two groups of
    one warp, of two warps of one block, or of two blocks."""
    per_warp = 32 // geometry.lanes
    per_block = kernel.WARP_THREADS // geometry.lanes
    groups = {}
    for key, g in flushes:
        groups.setdefault(key, set()).add(g)
    kinds = set()
    for gs in groups.values():
        gs = sorted(gs)
        for a, b in zip(gs, gs[1:]):
            if a // per_block != b // per_block:
                kinds.add("block")
            elif a // per_warp != b // per_warp:
                kinds.add("warp")
            else:
                kinds.add("range")
    return kinds


def _layout(scale=10, deg=16, part_size=100, seed=2, edge_block=16):
    g = generators.rmat(scale, deg, seed=seed)
    blk = block_png(build_png(g, Partitioning(g.num_nodes, part_size)))
    return g, pack_blocked(blk, g.num_nodes, edge_block=edge_block,
                           device="cpu")


def _reorder(packed, order, seed=0):
    """The packed streams with each partition's slots (pads included)
    kept in place, shuffled or reversed: a slot's partition is its
    position, so only the order inside a partition may change."""
    eu = packed.edge_upd.clone()
    ed = packed.edge_dst.clone()
    if order == "dst-sorted":
        return eu, ed
    k, n_eb, eb = eu.shape
    flat_u, flat_d = eu.view(k, -1), ed.view(k, -1)
    gen = torch.Generator().manual_seed(seed)
    for p in range(k):
        perm = (torch.randperm(n_eb * eb, generator=gen)
                if order == "shuffled"
                else torch.arange(n_eb * eb - 1, -1, -1))
        flat_u[p] = flat_u[p][perm]
        flat_d[p] = flat_d[p][perm]
    return eu, ed


def _x(n, d, seed, dtype=torch.float32):
    """Multiples of 1/16 below 1: every order of the sums gives the same
    float32 bits, so the emulation must equal the plain version."""
    x = np.random.default_rng(seed).integers(0, 16, (n, d)) / 16
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _bins(packed, x):
    k, u = packed.update_src.shape
    return x[packed.update_src.view(-1).long()].view(k, u, x.shape[1])


def _geometry(d, bf16=False, aligned=True, blocks=1, part_slots=0):
    return kernel.warp_geometry(d, bf16, aligned, part_slots,
                                lambda vec, lanes: blocks)


# ------------------------------------------------------------ geometry
def test_lanes_and_slices():
    assert kernel.warp_lanes(16, False, True) == (4, 4)   # 64-byte rows
    assert kernel.warp_lanes(16, True, True) == (8, 2)    # bfloat16
    assert kernel.warp_lanes(16, False, False) == (1, 16)  # unaligned rows
    assert kernel.warp_lanes(1, False, True) == (1, 1)
    assert kernel.warp_lanes(3, False, True) == (1, 4)
    assert kernel.warp_lanes(17, False, True) == (1, 32)
    assert kernel.warp_lanes(40, False, True) == (4, 16)
    assert kernel.warp_lanes(12, True, True) == (1, 16)   # 12 % 8 != 0
    for d in range(1, 300):
        for bf16 in (False, True):
            vec, lanes = kernel.warp_lanes(d, bf16, True)
            assert lanes in (1, 2, 4, 8, 16, 32) and vec in (1, 4, 8)
            assert d % vec == 0
            # one column tile (one pass over the stream) unless 32 lanes
            # cannot cover the row
            assert lanes == 32 or lanes * vec >= d
            assert lanes == 1 or (lanes // 2) * vec < d


def test_range_covers_about_one_partition_a_round():
    # kron-21 at d = 16: 2,262,528 slots a partition (512-slot blocks)
    geo = kernel.warp_geometry(16, False, True, 2_262_528,
                               lambda vec, lanes: 132 * 3)
    assert (geo.vec, geo.lanes, geo.blocks) == (4, 4, 396)
    assert geo.range % 16 == 0
    window = geo.groups * geo.range
    assert window <= 2_262_528 < window + geo.groups * 16
    # a stream shorter than one fetch a group: one fetch a round
    assert _geometry(16, part_slots=100).range == 16


def test_sources_constants():
    source = kernel.SOURCE.read_text()
    body = source[source.index("namespace warp {"):
                  source.index("}  // namespace warp")]
    assert re.search(r"constexpr int kThreads = (\d+);", body).group(1) == \
        str(kernel.WARP_THREADS)
    # the kernels the C side instantiates are the lanes warp_lanes gives
    assert sorted(map(int, re.findall(r"case (\d+): return gather_kernel",
                                      body))) == [1, 2, 4, 8, 16, 32]


# ------------------------------------------------- the kernel's loop
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("fused", [False, True])
def test_warp_loop_emulation_matches_plain(d, order, fused):
    g, packed = _layout()
    eu, ed = _reorder(packed, order, seed=d)
    x = _x(g.num_nodes, d, seed=d)
    geo = _geometry(d, blocks=2)
    if fused:
        got, _ = emulate_warp_loop(x, eu, ed, packed.part_size, geo,
                                   update_src=packed.update_src)
        want = pcpm_spmv_ref(x, packed.update_src, eu, ed,
                             part_size=packed.part_size)
    else:
        bins = _bins(packed, x)
        got, _ = emulate_warp_loop(bins, eu, ed, packed.part_size, geo)
        want = pcpm_gather_ref(bins, eu, ed, part_size=packed.part_size)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_runs_cross_range_warp_and_block_edges(fused):
    """On the destination-sorted stream, with ranges of one fetch, the
    runs of a destination are cut at the edges between two groups' ranges
    inside a warp, between warps and between blocks, and still sum to the
    plain version's output."""
    g, packed = _layout()
    x = _x(g.num_nodes, 16, seed=1)
    geo = _geometry(16, blocks=2)
    assert geo.range == 16 and geo.lanes == 4
    rows = x if fused else _bins(packed, x)
    got, flushes = emulate_warp_loop(
        rows, packed.edge_upd, packed.edge_dst, packed.part_size, geo,
        update_src=packed.update_src if fused else None)
    assert crossings(flushes, geo) == {"range", "warp", "block"}
    torch.testing.assert_close(got, pcpm_spmv_ref(
        x, packed.update_src, packed.edge_upd, packed.edge_dst,
        part_size=packed.part_size), rtol=0, atol=0)


@pytest.mark.parametrize("d", [1, 16, 17])
def test_pads_in_the_middle_end_no_run(d):
    """Pads of every kind (update U or below 0, destination P or below 0)
    put between edges of one destination add nothing and leave the run
    going."""
    g, packed = _layout()
    eu, ed = packed.edge_upd.clone(), packed.edge_dst.clone()
    flat_u, flat_d = eu.view(-1), ed.view(-1)
    u_slots = packed.update_src.shape[1]
    real = torch.nonzero((flat_u < u_slots)
                         & (flat_d < packed.part_size)).view(-1)
    pick = real[torch.randperm(len(real),
                               generator=torch.Generator().manual_seed(d))
                [:len(real) // 5]]
    pads = [(u_slots, None), (-1, None), (None, packed.part_size),
            (None, -3)]
    for i, slot in enumerate(pick.tolist()):
        pu, pd = pads[i % 4]
        if pu is not None:
            flat_u[slot] = pu
        if pd is not None:
            flat_d[slot] = pd
    x = _x(g.num_nodes, d, seed=5)
    geo = _geometry(d, blocks=1)
    got, _ = emulate_warp_loop(x, eu, ed, packed.part_size, geo,
                               update_src=packed.update_src)
    torch.testing.assert_close(got, pcpm_spmv_ref(
        x, packed.update_src, eu, ed, part_size=packed.part_size),
        rtol=0, atol=0)
    # the runs really are longer than the pads between their edges
    _, base = emulate_warp_loop(x, packed.edge_upd, packed.edge_dst,
                                packed.part_size, geo,
                                update_src=packed.update_src)
    _, padded = emulate_warp_loop(x, eu, ed, packed.part_size, geo,
                                  update_src=packed.update_src)
    assert len(padded) <= len(base)


def test_all_pad_partition_gives_zeros():
    g, packed = _layout()
    eu, ed = packed.edge_upd.clone(), packed.edge_dst.clone()
    eu[1] = packed.update_src.shape[1]
    ed[1] = packed.part_size
    x = _x(g.num_nodes, 16, seed=2)
    got, _ = emulate_warp_loop(x, eu, ed, packed.part_size,
                               _geometry(16, blocks=1),
                               update_src=packed.update_src)
    assert not got[1].any() and got.any()
    torch.testing.assert_close(got, pcpm_spmv_ref(
        x, packed.update_src, eu, ed, part_size=packed.part_size),
        rtol=0, atol=0)


@pytest.mark.parametrize("part_size,edge_block", [(1, 1), (3, 3)])
def test_partitions_shorter_than_a_fetch(part_size, edge_block):
    """The paper's graph (fig. 3a): at one node a partition E = 2 slots,
    so one 4-slot lane fetch spans two partitions and a group's 16-slot
    fetch eight; at three nodes E = 6 and the stream's 18 slots end
    ragged (not a multiple of 4)."""
    g = formats.from_edge_list(9, PAPER_EDGES)
    blk = block_png(build_png(g, Partitioning(9, part_size)))
    packed = pack_blocked(blk, 9, edge_block=edge_block, device="cpu")
    k, n_eb, eb = packed.edge_upd.shape
    assert n_eb * eb == 2 * part_size and k * n_eb * eb == 18
    x = _x(9, 16, seed=4)
    for geo in (_geometry(16, blocks=1), WarpGeometry(4, 4, 1, 32),
                WarpGeometry(1, 1, 1, 4)):
        got, _ = emulate_warp_loop(x, packed.edge_upd, packed.edge_dst,
                                   packed.part_size, geo,
                                   update_src=packed.update_src)
        want = pcpm_spmv_ref(x, packed.update_src, packed.edge_upd,
                             packed.edge_dst, part_size=packed.part_size)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        np.testing.assert_array_equal(
            want.view(-1, 16)[:9].numpy(),
            dense_spmv(9, PAPER_EDGES[:, 0], PAPER_EDGES[:, 1],
                       x.numpy().astype(np.float64)).astype(np.float32))


@pytest.mark.parametrize("d", [1, 3, 16, 17])
@pytest.mark.parametrize("aligned", [True, False])
def test_bf16_rows(d, aligned):
    g, packed = _layout()
    eu, ed = _reorder(packed, "shuffled", seed=11)
    x = _x(g.num_nodes, d, seed=d, dtype=torch.bfloat16)
    geo = _geometry(d, bf16=True, aligned=aligned, blocks=1)
    assert geo.vec == (8 if aligned and d % 8 == 0 else 1)
    for fused in (False, True):
        rows = x if fused else _bins(packed, x)
        got, _ = emulate_warp_loop(
            rows, eu, ed, packed.part_size, geo,
            update_src=packed.update_src if fused else None)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, pcpm_spmv_ref(
            x, packed.update_src, eu, ed, part_size=packed.part_size),
            rtol=0, atol=0)


def test_update_src_outside_x_makes_pads():
    """An ``update_src`` entry outside [0, n) (above n or negative) turns
    the edges that read it into pads, on the card and in the plain
    version alike."""
    g, packed = _layout()
    x = _x(g.num_nodes, 16, seed=6)
    bad = packed.update_src.clone()
    bad[0, 3] = g.num_nodes
    bad[1, 0] = -1
    got, _ = emulate_warp_loop(x, packed.edge_upd, packed.edge_dst,
                               packed.part_size, _geometry(16, blocks=1),
                               update_src=bad)
    eu = packed.edge_upd.clone()
    eu[0][eu[0] == 3] = packed.update_src.shape[1]      # those edges: pads
    eu[1][eu[1] == 0] = packed.update_src.shape[1]
    want = pcpm_spmv_ref(x, packed.update_src, eu, packed.edge_dst,
                         part_size=packed.part_size)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(pcpm_spmv_ref(
        x, bad, packed.edge_upd, packed.edge_dst,
        part_size=packed.part_size), want, rtol=0, atol=0)


# ------------------------------------ the fused plain version vs JAX
@pytest.mark.parametrize("d", [1, 8, 16])
@pytest.mark.parametrize("scale,deg,part_size", [(9, 16, 64), (10, 16, 100)])
def test_fused_plain_version_matches_reference_pallas(scale, deg, part_size,
                                                      d):
    """``pcpm_spmv_ref`` against the JAX package's ``pcpm_spmv_pallas``
    (Pallas gather in interpret mode) on rmat graphs of at most 16K
    edges. rtol 1e-5: both sum float32 rows, the reference as a one-hot
    product over edge blocks and the port by ``index_add_``, in other
    orders (a few ulps on sums of up to ~100 terms)."""
    g = generators.rmat(scale, deg, seed=scale)
    r = ref_gen.rmat(scale, deg, seed=scale)
    assert g.num_edges <= 16384
    blk = block_png(build_png(g, Partitioning(g.num_nodes, part_size)))
    packed = pack_blocked(blk, g.num_nodes, edge_block=128, device="cpu")
    ref_blk = ref_core.block_png(ref_core.build_png(
        r, ref_core.Partitioning(r.num_nodes, part_size)))
    ref_packed = ref_ops.pack_blocked(ref_blk, r.num_nodes, edge_block=128)
    x = np.random.default_rng(d).random((g.num_nodes, d)).astype(np.float32)
    want = np.asarray(ref_ops.pcpm_spmv_pallas(ref_packed, jnp.asarray(x),
                                               interpret=True))
    out = pcpm_spmv_ref(torch.from_numpy(x), packed.update_src,
                        packed.edge_upd, packed.edge_dst,
                        part_size=part_size)
    got = out.view(-1, d)[:g.num_nodes].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # and through the port's SpMV entry point, which takes the fused form
    y = pcpm_spmv_pallas(packed, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-6)


# -------------------------------------------------------- the wrapper
def test_spmv_pallas_warp_route_makes_no_bins(monkeypatch):
    """``pcpm_spmv_pallas`` (the "warp" route, any d) hands ``x`` itself
    to the fused form and never calls the bins form; the "tile" route
    (``pcpm_spmv_tile``, d = 1) gathers the PNG's ragged (U,) bins for
    it."""
    g, packed = _layout()
    calls = []
    real = {"spmv": kernel.pcpm_spmv_cuda, "bins": kernel.pcpm_gather_cuda}

    def spy(name):
        def call(rows, *a, **kw):
            calls.append((name, rows.data_ptr(), tuple(rows.shape)))
            return real[name](rows, *a, **kw)
        return call

    real["ragged"] = kernel.tile_gather_cuda
    monkeypatch.setattr(ops, "pcpm_spmv_cuda", spy("spmv"))
    monkeypatch.setattr(ops, "tile_gather_cuda", spy("ragged"))
    for d in (1, 16):
        x = _x(g.num_nodes, d, seed=d)
        y = pcpm_spmv_pallas(packed, x if d > 1 else x[:, 0])
        assert calls.pop() == ("spmv", x.data_ptr(), (g.num_nodes, d))
        want = pcpm_spmv_ref(x, packed.update_src, packed.edge_upd,
                             packed.edge_dst, part_size=packed.part_size)
        torch.testing.assert_close(y.reshape(g.num_nodes, d),
                                   want.view(-1, d)[:g.num_nodes],
                                   rtol=0, atol=0)
    png = build_png(g, Partitioning(g.num_nodes, 100))
    ops.pcpm_spmv_tile(_x(g.num_nodes, 1, seed=1)[:, 0],
                       torch.from_numpy(png.update_src),
                       torch.from_numpy(png.update_offsets.astype(np.int32)),
                       ops.tile_schedule(png, device="cpu"))
    name, _, shape = calls.pop()
    assert (name, shape, calls) == ("ragged", (png.num_updates,), [])


def test_spmv_cuda_checks_and_counts_nothing_on_the_cpu():
    g, packed = _layout()
    x = _x(g.num_nodes, 4, seed=0)
    args = (packed.update_src, packed.edge_upd, packed.edge_dst)
    before = dict(kernel.launch_counts), kernel.launch_count
    out = pcpm_spmv_cuda(x, *args, part_size=packed.part_size)
    assert (dict(kernel.launch_counts), kernel.launch_count) == before
    assert out.shape == (packed.num_partitions, packed.part_size, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pcpm_spmv_cuda(x.double(), *args, part_size=packed.part_size)
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        pcpm_spmv_cuda(x[:, 0], *args, part_size=packed.part_size)
    with pytest.raises(ValueError, match="update_src"):
        pcpm_spmv_cuda(x, packed.update_src.long(), *args[1:],
                       part_size=packed.part_size)
    with pytest.raises(ValueError, match="update_src"):
        pcpm_spmv_cuda(x, packed.update_src[1:], *args[1:],
                       part_size=packed.part_size)
    with pytest.raises(ValueError, match="part_size"):
        pcpm_spmv_cuda(x, *args, part_size=0)
    with pytest.raises(ValueError, match="device"):
        pcpm_spmv_cuda(x.to("meta"), *args, part_size=packed.part_size)
