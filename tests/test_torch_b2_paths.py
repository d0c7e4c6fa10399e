"""Kernel B2's persistent grid and B2-bwd's column split, on the CPU.

The CUDA kernels cannot run here, so what decides and shapes their
launches is held here: B2's persistent grid (``geometry``,
``persistent_blocks``: each bag and column chunk once); B2-bwd's slab
geometry (``bwd_geometry``: every column covered once, grids and shared
memory within the card's limits, MIND's geometry unchanged), the form of
its walk (``bwd_form``), and a torch emulation of the column-split walk
(staged keys, the valid end, runs, head and tail partials, the combine
in chunk order) bit-equal to ``embedding_bag_bwd_emulate`` and within
float32 rounding of the JAX package's ``aggregate``.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro_torch.kernels.embedding_bag import (embedding_bag_bwd_emulate,
                                               sorted_keys)
from repro_torch.kernels.embedding_bag import kernel as k

from test_torch_reference import load_reference

ref_gnn = load_reference("models.gnn")

SMS = 132                      # the H100 SXM's streaming multiprocessors
SMEM_LIMIT = 227 * 1024        # dynamic shared memory a block may have


# ----------------------------------------------------- B2's grid
@pytest.mark.parametrize("b,d,el,bag_len", [
    (10_000, 512, 2, 1), (300, 64, 4, 4), (5, 13, 4, 1), (2000, 3, 4, 1),
    (40, 4096, 4, 2)])
def test_persistent_grid_covers_every_bag_once(b, d, el, bag_len):
    """Blocks capped to the resident ones stride over the bags: with L =
    1 a thread takes kSimtBatch bags (b0 + j * stride) at a time, else
    one; either way each (bag, column chunk) once."""
    vec, group, blocks = k.geometry(b, d, el)
    grid = k.persistent_blocks(blocks, sms=2)
    assert 1 <= grid <= min(blocks, 2 * k.BLOCKS_PER_SM)
    per_block = k.THREADS // group
    stride = grid * per_block
    batch = 4 if bag_len == 1 else 1            # kSimtBatch
    seen = torch.zeros((b, -(-d // vec)), dtype=torch.int64)
    for block in range(grid):
        for thread in range(per_block * group):
            slot, t = divmod(thread, group)
            for c in range(t, -(-d // vec), group):
                b0 = block * per_block + slot
                while b0 < b:
                    for j in range(batch):
                        bag = b0 + j * stride
                        if bag < b:
                            seen[bag, c] += 1
                    b0 += batch * stride
    assert (seen == 1).all()


# --------------------------------------------- B2-bwd's column split
def _bwd_smem_bytes(geo, weighted, form):
    """The chunk kernel's dynamic shared memory (``bwd_smem`` in the
    source): the block's staged keys (two more: the keys before and
    after), row indices and weights, then the walk's ring of
    ``k.BWD_RING`` 16-byte slots a thread."""
    span = geo.cpb * k.BWD_CHUNK
    up = lambda x, m: -(-x // m) * m            # noqa: E731
    rows = up((span + 2) * 4, 16)
    weights = rows + up(span * 4, 16)
    ring = up(weights + (span * 4 if weighted else 0), 128)
    return ring + (k.BWD_RING * geo.threads * 16 if form != "sync" else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 7, 8, 64, 288, 512, 1152, 6272])
def test_bwd_slab_geometry_covers_every_column_once(d, dtype):
    es = torch.empty((), dtype=dtype).element_size()
    vec = 16 // es
    geo = k.bwd_geometry(5, d, es)
    assert 1 <= geo.team <= 32 and geo.slab_cols == geo.team * vec
    assert geo.threads % 32 == 0 and geo.threads <= k.THREADS
    assert geo.cpb * geo.spb * geo.team <= geo.threads
    assert geo.grid_y <= 65535 and geo.grid_x >= 1
    assert geo.spb <= k.BWD_MAX_SLABS_PER_BLOCK
    assert geo.cpb <= k.BWD_MAX_CHUNKS_PER_BLOCK
    if -(-d // vec) <= 32:                   # narrow: one slab, packed
        assert (geo.slabs, geo.spb, geo.grid_y) == (1, 1, 1)
    else:                                    # wide: a warp a slab
        assert geo.team == 32 and geo.slab_cols == 512 // es
    for weighted in (False, True):
        for form in k.BWD_FORMS:
            assert _bwd_smem_bytes(geo, weighted, form) <= SMEM_LIMIT
    covered = torch.zeros(d, dtype=torch.int64)
    for by in range(geo.grid_y):
        for thread in range(geo.threads):
            tm, lane = divmod(thread, geo.team)
            if tm >= geo.cpb * geo.spb or tm // geo.spb != 0:
                continue                     # other chunks of the block
            slab = by * geo.spb + tm % geo.spb
            c0 = slab * geo.slab_cols + lane * vec
            if slab * geo.slab_cols >= d or c0 >= d:
                continue
            covered[c0:c0 + vec] += 1
    assert (covered == 1).all()


def test_bwd_geometry_at_mind_and_gnn_widths():
    # MIND's d 64 float32: today's packing (16 threads, 16 chunks a
    # block, 816 blocks at train_batch's 13,056 chunks)
    geo = k.bwd_geometry(13_056, 64, 4)
    assert (geo.team, geo.cpb, geo.spb, geo.threads, geo.grid_x,
            geo.grid_y) == (16, 16, 1, 256, 816, 1)
    assert k.geometry(13_056, 64, 4)[1:] == (16, 816)
    # equiformer-v2's d 6272 bfloat16: 42 chunks x 25 slabs (1,050
    # warps) in 4 slab groups of 7
    geo = k.bwd_geometry(42, 6272, 2)
    assert (geo.slabs, geo.spb, geo.cpb, geo.grid_x, geo.grid_y) == (
        25, 7, 1, 42, 4)
    # graphcast's d 512: 2 slabs, 4 chunks a block
    geo = k.bwd_geometry(7552, 512, 2)
    assert (geo.slabs, geo.spb, geo.cpb, geo.threads, geo.grid_x) == (
        2, 2, 4, 256, 1888)
    # the edge softmax's (E, 8) float32: 2 threads a chunk, 16 chunks,
    # a block of THREADS to stage them
    geo = k.bwd_geometry(42, 8, 4)
    assert (geo.team, geo.cpb, geo.threads, geo.grid_x) == (2, 16, 256, 3)


def test_bwd_form_is_the_alignment():
    assert k.bwd_form(True) == "cp.async"
    assert k.bwd_form(False) == "sync"
    assert k.BWD_FORMS == ("sync", "cp.async")     # the order of enum Form
    src = k.SOURCE.read_text()
    assert "enum Form { kSync = 0, kCpAsync = 1 };" in src


def _emulate_bwd_walk(dout, idx, weights, num_rows, chunk):
    """B2-bwd as the column-split kernels run it, in torch: the sorted
    entries staged block by block (keys with the one before and after),
    each (chunk, slab) team's walk to its valid end (a binary search),
    runs summed in entry order in float32 (w · dout rounded, then the
    add), written directly or left as head/tail partials; the combine in
    chunk order; zeros for the rows no entry reads. Returns (grad, per
    element write counts)."""
    v, d = num_rows, dout.shape[1]
    es = dout.element_size()
    vec = 16 // es
    keys, perm = sorted_keys(idx, v)
    keys = keys.tolist()
    n = len(keys)
    n_chunks = -(-n // chunk)
    geo = k.bwd_geometry(n_chunks, d, es)
    span = geo.cpb * chunk
    rows = (perm // idx.shape[1]).tolist()
    wts = (None if weights is None
           else weights.float().reshape(-1)[perm])
    x = dout.float()
    grad = torch.full((v, d), float("nan"))
    writes = torch.zeros((v, d), dtype=torch.int64)
    present = torch.zeros(v, dtype=torch.bool)
    head = torch.full((n_chunks, d), float("nan"))
    tail = torch.full((n_chunks, d), float("nan"))

    def key(e, s1):
        return keys[e] if 0 <= e < n and e <= s1 else -1

    for bx in range(geo.grid_x):
        s0 = bx * span
        s1 = min(s0 + span, n)
        ks = [key(e, s1) for e in range(s0 - 1, s0 + span + 1)]
        for by in range(geo.grid_y):
            for tm in range(geo.cpb * geo.spb):
                cl, slab = tm // geo.spb, by * geo.spb + tm % geo.spb
                lo_col = slab * geo.slab_cols
                if lo_col >= d:
                    continue
                cols = slice(lo_col, min(d, lo_col + geo.slab_cols))
                c = bx * geo.cpb + cl
                s = c * chunk
                if s >= n:
                    continue
                base, cnt = s - s0, min(s + chunk, n) - s
                first = ks[base + 1]
                if first >= v:
                    continue
                lo, hi = 0, cnt
                while lo < hi:
                    mid = (lo + hi) // 2
                    lo, hi = (mid + 1, hi) if ks[base + 1 + mid] < v else (
                        lo, mid)
                head_cont = ks[base] == first
                last = ks[base + cnt]
                tail_cont = last < v and ks[base + cnt + 1] == last

                def flush(acc, key_, start, final):
                    if start == 0 and head_cont:
                        head[c, cols] = acc
                    elif final and tail_cont:
                        tail[c, cols] = acc
                    else:
                        grad[key_, cols] = acc
                        writes[key_, cols] += 1
                    if slab == 0:
                        present[key_] = True

                acc = torch.zeros(cols.stop - cols.start)
                run_key, run_start = first, 0
                for e in range(lo):
                    kk = ks[base + 1 + e]
                    if kk != run_key:
                        flush(acc, run_key, run_start, False)
                        acc = torch.zeros_like(acc)
                        run_key, run_start = kk, e
                    val = x[rows[s + e], cols]
                    acc = acc + (val if wts is None else wts[s + e] * val)
                flush(acc, run_key, run_start, True)
    # the combine: a run whose first piece is a chunk's tail
    for c in range(n_chunks):
        s, e_end = c * chunk, min((c + 1) * chunk, n)
        last = keys[e_end - 1]
        if last >= v or e_end >= n or keys[e_end] != last:
            continue
        if s > 0 and keys[s] == last and keys[s - 1] == last:
            continue
        acc = tail[c].clone()
        kk = c + 1
        while True:
            acc = acc + head[kk]
            end = min((kk + 1) * chunk, n)
            if not (end < n and keys[end] == last):
                break
            kk += 1
        grad[last] = acc
        writes[last] += 1
    grad[~present] = 0.0
    writes[~present] += 1
    return grad.to(dout.dtype), writes


WALKS = [  # (n entries, L, V, d, dtype, chunk, weighted, hot)
    (60, 1, 9, 8, torch.float32, 4, True, None),      # edge softmax width
    (90, 3, 20, 64, torch.float32, 8, False, 3),      # MIND's width
    (70, 1, 11, 300, torch.float32, 8, True, 5),      # 3 slabs, one partial
    (50, 1, 7, 520, torch.bfloat16, 16, True, 2),     # 3 slabs
    (40, 2, 13, 13, torch.float32, 8, False, None),   # odd d: "sync"
    (80, 1, 6, 7, torch.bfloat16, 256, False, 1),     # one chunk
]


@pytest.mark.parametrize("n,l,v,d,dtype,chunk,weighted,hot", WALKS)
def test_column_split_walk_emulation(n, l, v, d, dtype, chunk, weighted,
                                     hot):
    rng = np.random.default_rng(n + d)
    b = n // l
    idx = rng.integers(-2, v + 3, (b, l))
    if hot is not None:                      # runs across many chunks
        idx[rng.random((b, l)) < 0.5] = hot
    idx = torch.from_numpy(idx)
    dout = torch.from_numpy(rng.standard_normal((b, d)).astype(
        np.float32)).to(dtype)
    w = (torch.from_numpy(rng.random((b, l)).astype(np.float32))
         if weighted else None)
    grad, writes = _emulate_bwd_walk(dout, idx, w, v, chunk)
    assert (writes == 1).all()               # every gradient value once
    want = embedding_bag_bwd_emulate(dout, idx, w, v, chunk)
    assert torch.equal(grad.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
    if l != 1:
        return
    # the JAX package's aggregate (a segment-sum by destination with the
    # mask, negative ids dropped there; here they read row 0, as the
    # port's segment_sum maps them to the pad first): within float32
    # rounding of the sums, 2 (n - 1) u sum |terms| per element
    keep = idx[:, 0] >= 0
    vals = dout.float().numpy()[keep.numpy()]
    seg = idx[keep, 0].numpy().astype(np.int32)
    mask = (np.ones(int(keep.sum()), np.float32) if w is None
            else w[keep, 0].numpy())
    jax_sum = np.asarray(ref_gnn.aggregate(jnp.asarray(vals),
                                           jnp.asarray(seg), v,
                                           jnp.asarray(mask)))
    mine = embedding_bag_bwd_emulate(dout[keep].float(), idx[keep], None
                                     if w is None else w[keep], v, chunk)
    terms = np.abs(vals * mask[:, None])
    absum = np.zeros((v, d), np.float32)
    counts = np.zeros(v)
    for i, s in enumerate(seg):
        if s < v:
            absum[s] += terms[i]
            counts[s] += 1
    bound = 2 * np.maximum(counts - 1, 0)[:, None] * 2.0 ** -24 * absum
    assert (np.abs(mine.numpy() - jax_sum) <= bound + 1e-30).all()
