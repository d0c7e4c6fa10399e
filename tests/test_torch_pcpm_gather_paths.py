"""Kernel B1's two paths on the CPU: the "tile" path's gather order and
chunk table (``ops.tile_schedule``) against the reference's packed
streams, a torch emulation of the CUDA source's chunk loop against the
plain version, ``b1_path``, the packed C arguments, and PageRank through
the new order against the reference's ``pagerank()``.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro_torch
from repro_torch.core import Partitioning, block_png, build_png
from repro_torch.graphs import formats, generators
from repro_torch.kernels.pcpm_spmv import (TileSchedule, b1_path, kernel,
                                           ops, pack_blocked,
                                           pcpm_gather_ref, tile_gather_cuda,
                                           tile_gather_ref, tile_schedule)

from test_torch_reference import hand_schedule, load_reference

ref_gen = load_reference("graphs.generators")
ref_formats = load_reference("graphs.formats")
ref_core = load_reference("core")
ref_ops = load_reference("kernels.pcpm_spmv.ops")

# paper fig. 3a (tests/test_core_pcpm.py PAPER_EDGES): 9 nodes, 3 per part
PAPER_EDGES = np.array([
    [6, 2], [7, 0], [7, 1], [7, 2],
    [3, 4], [6, 3], [6, 4], [6, 5],
    [2, 8], [7, 8],
], dtype=np.int32)
GRAPHS = ["paper", "rmat8", "rmat10", "grid"]
# (tile_bytes, blocks): one tile per partition, several, and more blocks
# than edges
SCHEDULES = [(1024, 3), (64, 7), (16, 5000)]


def _graphs(name):
    if name == "paper":
        return (formats.from_edge_list(9, PAPER_EDGES),
                ref_formats.from_edge_list(9, PAPER_EDGES), 3)
    if name == "rmat8":
        return generators.rmat(8, 8, seed=1), ref_gen.rmat(8, 8, seed=1), 64
    if name == "rmat10":
        return (generators.rmat(10, 16, seed=2), ref_gen.rmat(10, 16, seed=2),
                100)
    return generators.grid_2d(9, 13), ref_gen.grid_2d(9, 13), 16


def _layout(name):
    g, r, part_size = _graphs(name)
    png = build_png(g, Partitioning(g.num_nodes, part_size))
    ref_blk = ref_core.block_png(ref_core.build_png(
        r, ref_core.Partitioning(r.num_nodes, part_size)))
    return g, png, block_png(png), ref_blk


def _pairs(eu, ed, u_slots, part_size):
    """Per partition, the sorted (update, destination) pairs of the real
    edges of (k, E) streams."""
    out = []
    for p in range(eu.shape[0]):
        real = (eu[p] < u_slots) & (ed[p] < part_size)
        pairs = np.stack([eu[p][real], ed[p][real]], 1)
        out.append(pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))])
    return out


def _schedule_edges(s: TileSchedule):
    """Per chunk: its partition, tile and (upd, dst) edges."""
    eu, ed = s.edge_upd.numpy(), s.edge_dst.numpy()
    return [(p, t, eu[a:b], ed[a:b]) for p, t, a, b in s.chunks.tolist()]


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("tile_bytes,blocks", SCHEDULES)
def test_order_is_a_permutation_of_the_reference_pairs(name, tile_bytes,
                                                        blocks):
    g, png, blk, ref_blk = _layout(name)
    ref = ref_ops.pack_blocked(ref_blk, g.num_nodes, edge_block=16, lane=1)
    k, u_slots = np.asarray(ref.update_src).shape
    want = _pairs(np.asarray(ref.edge_upd).reshape(k, -1),
                  np.asarray(ref.edge_dst).reshape(k, -1), u_slots,
                  blk.part_size)
    s = tile_schedule(png, tile_bytes=tile_bytes, blocks=blocks, device="cpu")
    got = [[] for _ in range(k)]
    for p, _, eu, ed in _schedule_edges(s):
        got[p].append(np.stack([eu, ed], 1))
    for p in range(k):
        pairs = (np.concatenate(got[p]) if got[p]
                 else np.zeros((0, 2), np.int32))
        np.testing.assert_array_equal(
            pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))], want[p])
        # within a partition: (tile, update, destination) order
        key = [(int(d) // s.tile, int(u), int(d)) for u, d in pairs]
        assert key == sorted(key)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("tile_bytes,blocks", SCHEDULES)
def test_chunks_cover_the_real_edges_once_inside_one_tile(name, tile_bytes,
                                                          blocks):
    g, png, blk, _ = _layout(name)
    s = tile_schedule(png, tile_bytes=tile_bytes, blocks=blocks, device="cpu")
    assert s.tile == ops.tile_size(blk.part_size, tile_bytes)
    assert s.tile % 4 == 0 and s.tile * 4 <= max(tile_bytes, 16)
    chunks = s.chunks.numpy()
    m = s.edge_upd.shape[0]
    assert m == g.num_edges                         # no pad slot stored
    covered = np.zeros(m, dtype=np.int64)
    for p, t, a, b in chunks:
        assert a < b
        covered[a:b] += 1
    assert (covered == 1).all()                     # each edge once
    u_slots = blk.update_src.shape[1]
    for p, t, eu, ed in _schedule_edges(s):
        assert ((eu >= 0) & (eu < u_slots)).all()   # no pad in a chunk
        assert ((ed >= t * s.tile) & (ed < min((t + 1) * s.tile,
                                               blk.part_size))).all()
    starts = s.block_chunks.numpy()
    assert starts[0] == 0 and starts[-1] == len(chunks)
    assert s.blocks == blocks and (np.diff(starts) >= 0).all()
    # a block's chunks are one contiguous run of at most ceil(M / blocks)
    # edges
    for b in range(blocks):
        run = chunks[starts[b]:starts[b + 1]]
        if len(run):
            assert (run[1:, 2] == run[:-1, 3]).all()
            assert run[-1, 3] - run[0, 2] <= -(-m // blocks)


@pytest.mark.parametrize("name", GRAPHS)
def test_hubs_are_each_tiles_heaviest_destinations(name):
    _, png, blk, _ = _layout(name)
    s = tile_schedule(png, tile_bytes=64, blocks=3, device="cpu")
    n_tiles = -(-blk.part_size // s.tile)
    counts = np.zeros((s.num_partitions * n_tiles, s.tile), dtype=np.int64)
    for p, t, _, ed in _schedule_edges(s):
        np.add.at(counts[p * n_tiles + t], ed - t * s.tile, 1)
    for row, hubs in zip(counts, s.hubs.numpy()):
        named = hubs[hubs >= 0]
        assert len(set(named)) == len(named)
        assert (row[named] >= 2).all()
        assert list(row[named]) == sorted(row[named], reverse=True)
        rest = np.delete(row, named)
        if len(named) < ops.HUBS:                  # every heavier one named
            assert (rest < 2).all()
        elif len(rest):
            assert rest.max() <= row[named].min()


def test_tile_size_and_blocks():
    # kron-21's partitions: 65536 destinations in three tiles of 87,424 B
    assert ops.tile_size(65536) == 21848
    assert ops.tile_size(65536, 128 * 1024) == 32768
    assert ops.tile_size(9, 16) == 4 and ops.tile_size(3) == 4
    assert ops.tile_blocks(torch.device("cpu")) == 2 * ops.H100_SMS
    assert ops.tile_blocks(torch.device("cpu"), 128 * 1024) == ops.H100_SMS


def test_hub_count_is_the_sources():
    source = kernel.SOURCE.read_text()
    assert re.search(r"constexpr int kHubs = (\d+);", source).group(1) == \
        str(ops.HUBS)


def test_b1_path_choices():
    assert b1_path(1, True) == "tile"
    assert b1_path(1, False) == "warp"
    for d in (2, 8, 16, 32):
        assert b1_path(d, True) == "warp" and b1_path(d, False) == "warp"


# ------------------------------------------------ the kernel's chunk loop
def emulate_tile_loop(bins: torch.Tensor, offsets: torch.Tensor,
                      s: TileSchedule) -> torch.Tensor:
    """B1's "tile" path as the CUDA source runs it on ragged bins (U,),
    partition p's from ``offsets[p]``, block by block and
    chunk by chunk: zero the tile, the ragged edges (up to 3 before the
    first 16-byte boundary of the streams and after the last, one a
    thread) and the aligned body (groups of 4), shared adds inside the
    tile (a hub's in its own sum, added once at the chunk's end) and
    global adds outside it, then the flush (scalar up to the output's
    first 16-byte boundary, groups of 4 skipped when all zero, the scalar
    rest). Asserts that each edge and each tile slot is taken exactly
    once."""
    k = s.num_partitions
    p_size, tile = s.part_size, s.tile
    eu, ed = s.edge_upd.long(), s.edge_dst.long()
    out = torch.zeros(k * p_size, dtype=torch.float32)
    vals = bins.float().view(-1)
    off = offsets.tolist()
    chunks, starts = s.chunks.tolist(), s.block_chunks.tolist()
    n_tiles = -(-p_size // tile)
    for b in range(s.blocks):
        for p, t, first, end in chunks[starts[b]:starts[b + 1]]:
            hubs = [h for h in s.hubs[p * n_tiles + t].tolist() if h >= 0]
            hub_sum = torch.zeros(len(hubs), dtype=torch.float32)
            t0 = t * tile
            tn = max(0, min(tile, p_size - t0))
            sacc = torch.zeros(tile, dtype=torch.float32)
            a0 = min(end, (first + 3) & ~3)
            a1 = max(a0, end & ~3)
            ragged = [first + i if first + i < a0 else a1 + (i - (a0 - first))
                      for i in range((a0 - first) + (end - a1))]
            body = [e for i in range(a0 // 4, a1 // 4)
                    for e in range(4 * i, 4 * i + 4)]
            edges = torch.tensor(ragged + body, dtype=torch.long)
            assert sorted(edges.tolist()) == list(range(first, end))
            if len(edges):
                u, j = eu[edges], ed[edges]
                up = off[p + 1] - off[p]               # partition p's bins
                ok = (u >= 0) & (u < up) & (j >= 0) & (j < p_size)
                u, j = u[ok], j[ok]
                v = vals[off[p] + u]
                jt = j - t0
                inside = (jt >= 0) & (jt < tn)
                out.index_add_(0, p * p_size + j[~inside], v[~inside])
                jt, v = jt[inside], v[inside]
                is_hub = torch.zeros_like(inside[inside])
                for q, h in enumerate(hubs):
                    hub_sum[q] += v[jt == h].sum()
                    is_hub |= jt == h
                sacc.index_add_(0, jt[~is_hub], v[~is_hub])
            for q, h in enumerate(hubs):
                if h < tn and hub_sum[q] != 0:
                    sacc[h] += hub_sum[q]
            base = p * p_size + t0
            lead = min(tn, (4 - (base & 3)) & 3)
            nv = (tn - lead) // 4
            slots = list(range(lead)) + list(range(lead + 4 * nv, tn))
            for i in slots:
                if sacc[i] != 0:
                    out[base + i] += sacc[i]
            for q in range(nv):
                i = lead + 4 * q
                assert (base + i) % 4 == 0       # a 16-byte aligned float4
                group = sacc[i:i + 4]
                if (group != 0).any():
                    out[base + i:base + i + 4] += group
                slots += range(i, i + 4)
            assert sorted(slots) == list(range(tn))
    return out.view(k, p_size, 1)


def _packed_and_bins(name, *, exact, seed=0):
    """The PNG, its packed blocked streams, the padded bins (k, U, 1) of
    a random x that the "warp" path's plain version reads, and the
    ragged bins (U,) with their offsets that the "tile" path reads."""
    g, png, blk, _ = _layout(name)
    packed = pack_blocked(blk, g.num_nodes, edge_block=16, device="cpu")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.integers(0, 16, g.num_nodes) / 16 if exact
                          else rng.random(g.num_nodes)).astype(np.float32))
    k, u = packed.update_src.shape
    bins = x[packed.update_src.view(-1)].view(k, u, 1)
    ragged = x[torch.from_numpy(png.update_src).long()]
    offsets = torch.from_numpy(png.update_offsets.astype(np.int32))
    return png, packed, bins, ragged, offsets


def _streams(packed, order, seed):
    """The real edges of the packed streams, partition after partition,
    each partition's in the packed (destination) order or shuffled."""
    k, u = packed.update_src.shape
    eu = packed.edge_upd.reshape(k, -1).numpy()
    ed = packed.edge_dst.reshape(k, -1).numpy()
    rng = np.random.default_rng(seed)
    parts, ups, dsts = [], [], []
    for p in range(k):
        real = np.flatnonzero((eu[p] < u) & (ed[p] < packed.part_size))
        if order == "random":
            real = rng.permutation(real)
        parts.append(np.full(len(real), p))
        ups.append(eu[p][real])
        dsts.append(ed[p][real])
    return (np.concatenate(parts), np.concatenate(ups),
            np.concatenate(dsts))


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("order", ["update-major", "dst-sorted", "random"])
@pytest.mark.parametrize("exact", [True, False])
def test_tile_loop_emulation_matches_plain(name, order, exact):
    png, packed, bins, ragged, offsets = _packed_and_bins(
        name, exact=exact, seed=len(order))
    psz = packed.part_size
    if order == "update-major":
        s = tile_schedule(png, tile_bytes=64, blocks=5, device="cpu")
    else:
        # chunks cut by count, each given the tile of its first edge: the
        # other edges of a chunk fall outside it and go to the global adds
        s = hand_schedule(*_streams(packed, order, seed=3),
                          part_size=psz,
                          num_partitions=packed.num_partitions,
                          tile=ops.tile_size(psz, 64),
                          chunk_edges=7, blocks=4)
    ref = pcpm_gather_ref(bins, packed.edge_upd, packed.edge_dst,
                          part_size=psz)
    tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(emulate_tile_loop(ragged, offsets, s), ref,
                               **tol)
    torch.testing.assert_close(tile_gather_ref(ragged, s, offsets), ref,
                               **tol)


def test_hand_schedule_puts_edges_outside_their_tile():
    _, packed, _, _, _ = _packed_and_bins("rmat10", exact=True)
    tile = ops.tile_size(packed.part_size, 64)
    s = hand_schedule(*_streams(packed, "random", seed=3),
                      part_size=packed.part_size,
                      num_partitions=packed.num_partitions, tile=tile,
                      chunk_edges=7, blocks=4)
    outside = sum(int(((ed < t * tile) | (ed >= (t + 1) * tile)).sum())
                  for _, t, _, ed in _schedule_edges(s))
    assert outside > 0


def test_schedule_rejects_a_bad_table():
    png = _packed_and_bins("rmat8", exact=True)[0]
    s = tile_schedule(png, tile_bytes=64, blocks=3, device="cpu")
    fields = dict(part_size=s.part_size, num_partitions=s.num_partitions,
                  tile=s.tile, edge_upd=s.edge_upd, edge_dst=s.edge_dst,
                  chunks=s.chunks, block_chunks=s.block_chunks,
                  hubs=s.hubs)
    bad = s.chunks.clone()
    bad[0, 3] = s.edge_upd.shape[0] + 1                 # end past M
    with pytest.raises(ValueError, match="out of range"):
        TileSchedule(**{**fields, "chunks": bad})
    bad = s.chunks.clone()
    bad[0, 0] = s.num_partitions                        # no such partition
    with pytest.raises(ValueError, match="out of range"):
        TileSchedule(**{**fields, "chunks": bad})
    with pytest.raises(ValueError, match="multiple of 4"):
        TileSchedule(**{**fields, "tile": 6})
    with pytest.raises(ValueError, match="int32"):
        TileSchedule(**{**fields, "edge_upd": s.edge_upd.long()})
    bad = s.hubs.clone()
    bad[0, :2] = 1                                      # a hub twice
    with pytest.raises(ValueError, match="hub table"):
        TileSchedule(**{**fields, "hubs": bad})
    bad[0, :2] = torch.tensor([s.tile, -1])             # past the tile
    with pytest.raises(ValueError, match="hub table"):
        TileSchedule(**{**fields, "hubs": bad})


# ---------------------------------------------------------- the wrapper
def test_wrapper_takes_the_tile_path_plain_version_on_the_cpu():
    png, packed, bins, ragged, offsets = _packed_and_bins("rmat10",
                                                          exact=True)
    s = tile_schedule(png, tile_bytes=64, blocks=5, device="cpu")
    before = dict(kernel.launch_counts), kernel.launch_count
    out = tile_gather_cuda(ragged, offsets, s)
    torch.testing.assert_close(out, pcpm_gather_ref(
        bins, packed.edge_upd, packed.edge_dst, part_size=packed.part_size),
        rtol=0, atol=0)
    assert (dict(kernel.launch_counts), kernel.launch_count) == before
    # the schedule of a layout with one more partition
    n_tiles = -(-packed.part_size // s.tile)
    other = TileSchedule(**{**s.__dict__,
                            "num_partitions": s.num_partitions + 1,
                            "hubs": torch.cat([s.hubs, torch.full(
                                (n_tiles, ops.HUBS), -1, dtype=torch.int32)])})
    with pytest.raises(ValueError, match="schedule"):
        tile_gather_cuda(ragged, offsets, other)


def _enum_names(source) -> list[str]:
    """The names of ``enum Arg`` in a kernel source, without the k and
    without kNumArgs, folded to lower case without underscores."""
    body = re.search(r"enum Arg \{(.*?)\};", source.read_text(), re.S)
    names = re.findall(r"^\s*k(\w+),", body.group(1), re.M)
    return [n.lower() for n in names if n != "NumArgs"]


def test_packed_arguments_are_the_c_sides_in_its_order():
    assert _enum_names(kernel.SOURCE) == [
        n.replace("_", "").lower() for n in kernel.ARGS.names]
    png, packed, bins, ragged, offsets = _packed_and_bins("rmat10",
                                                          exact=True)
    psz = packed.part_size
    s = tile_schedule(png, tile_bytes=64, blocks=5, device="cpu")
    k, u, d = bins.shape
    acc = torch.zeros((k, psz, 1))
    _, n_eb, eb = packed.edge_upd.shape
    common = dict(bf16=0, rows=bins.data_ptr(), update_src=0, n=0,
                  edge_upd=packed.edge_upd.data_ptr(),
                  edge_dst=packed.edge_dst.data_ptr(), acc=acc.data_ptr(),
                  out=0, k=k, U=u, n_eb=n_eb, Eb=eb, P=psz, d=d,
                  vec=0, lanes=0, range=0, update_offsets=0)
    # "tile", as tile_gather_cuda launches it: ragged bins (U,) with
    # their offsets and no blocked streams
    got = kernel.ARGS.unpack(kernel.launch_args(
        "tile", ragged, None, None, acc, None, psz,
        num_updates=png.num_updates, schedule=s, update_offsets=offsets))
    tile_tables = dict(tile_upd=s.edge_upd.data_ptr(),
                       tile_dst=s.edge_dst.data_ptr(),
                       chunks=s.chunks.data_ptr(),
                       block_chunks=s.block_chunks.data_ptr(),
                       hub_table=s.hubs.data_ptr(), tile=s.tile, blocks=5)
    assert got == dict(common, path=1, rows=ragged.data_ptr(), edge_upd=0,
                       edge_dst=0, U=png.num_updates, n_eb=0, Eb=0,
                       update_offsets=offsets.data_ptr(), **tile_tables)
    # "warp" from bins, as pcpm_gather_cuda launches it: bins as the
    # (k·U, d) rows of x with the identity update_src; its geometry, no
    # tile tables
    geometry = kernel.WarpGeometry(vec=8, lanes=2, blocks=3, range=24)
    out = torch.empty((k, psz, 1), dtype=torch.bfloat16)
    b16 = bins.bfloat16().view(k * u, d)
    identity = torch.arange(k * u, dtype=torch.int32).view(k, u)
    got = kernel.ARGS.unpack(kernel.launch_args(
        "warp", b16, packed.edge_upd, packed.edge_dst, acc, out,
        psz, num_updates=u, update_src=identity,
        geometry=geometry))
    tables = ("tile_upd", "tile_dst", "chunks", "block_chunks", "hub_table",
              "tile")
    assert got == dict(common, path=0, bf16=1, rows=b16.data_ptr(),
                       update_src=identity.data_ptr(), n=k * u,
                       out=out.data_ptr(), vec=8, lanes=2, range=24,
                       blocks=3, **dict.fromkeys(tables, 0))
    # the fused form: x (n, d) and update_src in place of bins
    x = torch.zeros((packed.num_nodes, 16))
    got = kernel.ARGS.unpack(kernel.launch_args(
        "warp", x, packed.edge_upd, packed.edge_dst, acc, None,
        psz, num_updates=u, update_src=packed.update_src,
        geometry=geometry))
    assert got == dict(common, path=0, rows=x.data_ptr(),
                       update_src=packed.update_src.data_ptr(),
                       n=packed.num_nodes, d=16, vec=8, lanes=2, range=24,
                       blocks=3, **dict.fromkeys(tables, 0))


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("name", ["rmat10", "grid"])
def test_pagerank_through_the_tile_order_matches_reference(name, monkeypatch):
    g, r, part_size = _graphs(name)
    calls = []
    monkeypatch.setattr(kernel, "tile_gather_ref",
                        lambda *a: calls.append(1) or tile_gather_ref(*a))
    cfg = repro_torch.EngineConfig(method="pcpm_pallas", part_size=part_size,
                                   num_iterations=30)
    res = repro_torch.open(g, cfg, device="cpu").pagerank()
    assert len(calls) == res.iterations == 30       # every SpMV, "tile"
    ref = ref_core.pagerank(r, method="pcpm", part_size=part_size,
                            num_iterations=30)
    assert np.abs(res.ranks.numpy() - np.asarray(ref.ranks)).max() <= 1e-6
    oracle = ref_core.pagerank_reference(r, num_iterations=30)
    assert np.abs(res.ranks.numpy() - oracle).max() <= 1e-6
    # and the blocked Pallas path of the reference on the same graph
    ref_blk = ref_core.block_png(ref_core.build_png(
        r, ref_core.Partitioning(r.num_nodes, part_size)))
    ref_packed = ref_ops.pack_blocked(ref_blk, r.num_nodes, edge_block=16)
    x = np.random.default_rng(0).random(r.num_nodes).astype(np.float32)
    y_ref = ref_ops.pcpm_spmv_pallas(ref_packed, jnp.asarray(x),
                                     interpret=True)
    png = build_png(g, Partitioning(g.num_nodes, part_size))
    y = ops.pcpm_spmv_tile(
        torch.from_numpy(x), torch.from_numpy(png.update_src),
        torch.from_numpy(png.update_offsets.astype(np.int32)),
        tile_schedule(png, device="cpu"))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-6)
