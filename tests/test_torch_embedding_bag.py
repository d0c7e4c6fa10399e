"""Kernel B2's plain version and index logic, on the CPU.

The port's ``embedding_bag_ref`` (and ``embedding_bag``, which runs it
for CPU tensors) against the JAX package's ``embedding_bag_ref`` and its
Pallas kernel in interpret mode, at the shapes of the reference's
``TestEmbeddingBag`` with its tolerance (rtol 1e-4, atol 1e-5: float32
sums in another order); on pad ids, one-id bags (MIND's ``lookup``) and
a negative id. The CUDA kernel cannot run here, so a torch emulation of
its thread mapping (``kernel.geometry``, 16-byte chunks, a scalar tail,
pad skip, negative clip) is held against the plain version.
"""
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro_torch.kernels import embedding_bag as b2
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_ref, geometry)

from test_torch_reference import load_reference

ref_bag = load_reference("kernels.embedding_bag")
ref_recsys = load_reference("models.recsys")

SHAPES = [(512, 128, 8, 4), (1024, 64, 32, 16), (2048, 128, 64, 8)]
TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, v, d, b, l, *, weighted=True):
    rng = np.random.default_rng(seed)
    table = rng.random((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    w = rng.random((b, l)).astype(np.float32) if weighted else None
    return table, idx, w


def _port(table, idx, w=None, id_dtype=torch.int32):
    return embedding_bag(torch.from_numpy(table),
                         torch.from_numpy(idx).to(id_dtype),
                         None if w is None else torch.from_numpy(w)).numpy()


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("v,d,b,l", SHAPES)
def test_matches_reference_and_pallas(v, d, b, l, weighted):
    table, idx, w = _inputs(v + d + b, v, d, b, l, weighted=weighted)
    out = _port(table, idx, w)
    jw = None if w is None else jnp.asarray(w)
    ref = ref_bag.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx), jw)
    pallas = ref_bag.embedding_bag(jnp.asarray(table), jnp.asarray(idx), jw,
                                   path="pallas", interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_pad_ids_are_inert(id_dtype):
    v, d = 512, 128
    table, _, _ = _inputs(0, v, d, 1, 1)
    idx = np.array([[0, 1, v, v], [2, v, v, v], [v + 7, v, 2 ** 30, v]],
                   np.int32)
    out = _port(table, idx, id_dtype=id_dtype)
    np.testing.assert_allclose(out[0], table[0] + table[1], rtol=1e-6)
    np.testing.assert_array_equal(out[1], table[2])
    np.testing.assert_array_equal(out[2], 0.0)
    pallas = ref_bag.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                   path="pallas", interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)


def test_one_id_bags_are_mind_lookup():
    v, d = 1000, 32
    table, _, _ = _inputs(1, v, d, 1, 1)
    ids = np.random.default_rng(1).integers(-3, v + 20, (16, 8)).astype(
        np.int32)
    ids[0, :3] = (-1, v, v - 1)
    out = _port(table, ids.reshape(-1, 1)).reshape(16, 8, d)
    ref = ref_recsys.lookup(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_negative_id_reads_row_zero():
    """The port follows ``embedding_bag_ref`` and MIND's ``lookup``: an id
    < 0 is clipped to row 0. The reference's Pallas path gives zero for
    it instead (its in-tile position is negative and matches no iota);
    the model's outputs depend on the clipping version."""
    v, d = 512, 8
    table, _, _ = _inputs(2, v, d, 1, 1)
    idx = np.array([[-1, 3, 512, 600]], np.int32)
    out = _port(table, idx)
    ref = ref_bag.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(out[0], table[0] + table[3], rtol=1e-6)
    pallas = ref_bag.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                   path="pallas", interpret=True)
    np.testing.assert_allclose(np.asarray(pallas)[0], table[3], rtol=1e-6)


def test_bf16_table_matches_pallas():
    """bfloat16 table and output: the port sums in float32 and rounds
    once; the Pallas kernel rounds the sum of each 512-row tile. Within
    two bfloat16 roundings (2 * 2**-8 relative)."""
    v, d, b, l = 1024, 64, 32, 16
    table, idx, w = _inputs(3, v, d, b, l)
    tb = torch.from_numpy(table).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    out = embedding_bag(tb, torch.from_numpy(idx), wb)
    assert out.dtype == torch.bfloat16
    pallas = ref_bag.embedding_bag(
        jnp.asarray(tb.float().numpy(), jnp.bfloat16), jnp.asarray(idx),
        jnp.asarray(wb.float().numpy(), jnp.bfloat16), path="pallas",
        interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=2 ** -7, atol=1e-5)


# ----------------------------------------------------- the kernel's loop
def _emulate_kernel(table, idx, weights=None):
    """B2's loop as the CUDA source runs it, thread by thread: blocks of
    ``THREADS``, ``group`` threads per bag, 16-byte column chunks (a
    vector read when full and 16-byte aligned, else value by value),
    float32 sums; pads skipped, negative ids clipped. Returns (out, the
    rows read, per-element write counts, vector reads, scalar reads)."""
    v, d = table.shape
    b, l = idx.shape
    el = table.element_size()
    vec, group, blocks = geometry(b, d, el)
    bags_per_block = b2.kernel.THREADS // group
    out = torch.full((b, d), float("nan"), dtype=table.dtype)
    writes = torch.zeros((b, d), dtype=torch.int64)
    rows_read, n_vec, n_scalar = set(), 0, 0
    base, ld = table.data_ptr(), table.stride(0)
    for block in range(blocks):
        for thread in range(b2.kernel.THREADS):
            slot, t = divmod(thread, group)
            bag = block * bags_per_block + slot
            if slot >= bags_per_block or bag >= b:
                continue
            for c0 in range(t * vec, d, group * vec):
                full = c0 + vec <= d
                acc = torch.zeros(vec, dtype=torch.float32)
                for j in range(l):
                    i = int(idx[bag, j])
                    if i >= v:
                        continue
                    i = max(i, 0)
                    rows_read.add(i)
                    if full and (base + (i * ld + c0) * el) % 16 == 0:
                        vals = table[i, c0:c0 + vec].float()
                        n_vec += 1
                    else:
                        vals = torch.zeros(vec, dtype=torch.float32)
                        n = min(vec, d - c0)
                        vals[:n] = table[i, c0:c0 + n].float()
                        n_scalar += 1
                    wt = 1.0 if weights is None else float(weights[bag, j])
                    acc = acc + wt * vals
                n = min(vec, d - c0)
                out[bag, c0:c0 + n] = acc[:n].to(table.dtype)
                writes[bag, c0:c0 + n] += 1
    return out, rows_read, writes, n_vec, n_scalar


def _odd_view(t):
    """``t`` as a view one element into a wider buffer: every row starts
    4 (float32) or 2 (bfloat16) bytes off a 16-byte boundary."""
    wide = torch.zeros((t.shape[0], t.shape[1] + 4), dtype=t.dtype)
    wide[:, 1:1 + t.shape[1]] = t
    return wide[:, 1:1 + t.shape[1]]


EMULATED = [  # (V, d, B, L, dtype, id dtype, weighted, odd view)
    (64, 64, 6, 3, torch.float32, torch.int32, False, False),   # MIND's d
    (64, 64, 5, 1, torch.float32, torch.int64, False, False),   # one-id
    (40, 6, 7, 4, torch.float32, torch.int32, True, False),     # tail
    (40, 13, 5, 3, torch.bfloat16, torch.int64, True, False),
    (40, 64, 4, 3, torch.bfloat16, torch.int32, False, False),
    (40, 32, 4, 3, torch.float32, torch.int32, True, True),     # unaligned
    (8, 1030, 2, 2, torch.float32, torch.int32, False, False),  # d > 1024
]


@pytest.mark.parametrize("v,d,b,l,dtype,id_dtype,weighted,odd", EMULATED)
def test_kernel_loop_emulation(v, d, b, l, dtype, id_dtype, weighted, odd):
    rng = np.random.default_rng(v + d + b)
    table = torch.from_numpy(rng.random((v, d)).astype(np.float32)).to(dtype)
    if odd:
        table = _odd_view(table)
    idx = rng.integers(-2, v + 3, (b, l))
    idx[0, 0] = v + 100                  # a pad beyond any row
    idx = torch.from_numpy(idx).to(id_dtype)
    w = (torch.from_numpy(rng.random((b, l)).astype(np.float32))
         if weighted else None)
    out, rows_read, writes, n_vec, n_scalar = _emulate_kernel(table, idx, w)
    assert (writes == 1).all()            # each output value written once
    valid = idx[idx < v].clamp(min=0)
    assert rows_read == set(valid.tolist())     # pads are never read
    aligned =(not odd and table.data_ptr() % 16 == 0
               and (d * table.element_size()) % 16 == 0)
    if aligned:                           # a row is one run of 16-byte loads
        assert n_scalar == 0 and n_vec > 0
    else:
        assert n_scalar > 0
    ref = embedding_bag_ref(table, idx, w)
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-6))
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_geometry_at_mind_width():
    # float32 d = 64: 16 threads (16 B each) per bag, 16 bags per block
    assert geometry(512 * 50, 64, 4) == (4, 16, 512 * 50 // 16)
    assert geometry(262144 * 50, 64, 4)[2] == 819_200
    # bfloat16: 8 columns per thread
    assert geometry(10, 64, 2) == (8, 8, 1)
    # wide rows: one bag per block, threads walk further chunks
    assert geometry(3, 4096, 4) == (4, 256, 3)


# ---------------------------------------------------------- the wrapper
def test_wrapper_checks_and_counts_no_cpu_launch():
    table = torch.rand(16, 8)
    idx = torch.zeros((2, 3), dtype=torch.int32)
    before = b2.kernel.launch_count
    torch.testing.assert_close(embedding_bag(table, idx), table[[0, 0]] * 3)
    assert b2.kernel.launch_count == before
    with pytest.raises(ValueError, match=r"\(V, d\)"):
        embedding_bag(table[0], idx)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        embedding_bag(table.half(), idx)
    with pytest.raises(ValueError, match=r"\(B, L\)"):
        embedding_bag(table, idx[0])
    with pytest.raises(TypeError, match="int32 or int64"):
        embedding_bag(table, idx.to(torch.int16))
    with pytest.raises(ValueError, match="shape of idx"):
        embedding_bag(table, idx, torch.ones(3, 2))
    with pytest.raises(TypeError, match="floating point"):
        embedding_bag(table, idx, torch.ones((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="one device"):
        embedding_bag(table, idx.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        embedding_bag(table.to("meta"), idx.to("meta"))
    assert b2.kernel.launch_count == before


def test_packed_arguments_are_the_c_sides_in_its_order():
    source = b2.kernel.SOURCE.read_text()
    body = re.search(r"enum Arg \{(.*?)\};", source, re.S).group(1)
    names = [n.lower() for n in re.findall(r"^\s*k(\w+),", body, re.M)
             if n != "NumArgs"]
    assert names == [n.replace("_", "").lower()
                     for n in b2.kernel.ARGS.names]
    table = torch.rand(16, 8)
    idx = torch.zeros((6, 3), dtype=torch.int64)[::2]       # strided bags
    w = torch.rand((3, 5))[:, 1:4]
    out = torch.empty((3, 8))
    got = b2.kernel.ARGS.unpack(b2.kernel.launch_args(
        table, idx, idx.shape, idx.stride(), w, out, group=2, blocks=1))
    assert got == dict(table_bf16=0, idx_64=1, table=table.data_ptr(), V=16,
                       ld=8, idx=idx.data_ptr(), idx_sb=6, idx_sl=1,
                       w=w.data_ptr(), w_sb=5, w_sl=1, out=out.data_ptr(),
                       B=3, L=3, d=8, group=2, blocks=1)
    # MIND's lookup: ids of any shape as (N, 1) bags, strides (1, 0)
    ids = torch.zeros((4, 5), dtype=torch.int32)
    got = b2.kernel.ARGS.unpack(b2.kernel.launch_args(
        table.bfloat16(), ids, (20, 1), (1, 0), None, out, group=1,
        blocks=3))
    assert (got["table_bf16"], got["idx_64"], got["idx"], got["idx_sb"],
            got["idx_sl"], got["B"], got["L"], got["w"], got["w_sb"],
            got["w_sl"], got["group"], got["blocks"]) == (
        1, 0, ids.data_ptr(), 1, 0, 20, 1, 0, 0, 0, 1, 3)


def test_lookup_is_one_id_bags_in_the_ids_shape():
    table = torch.rand(16, 8)
    ids = torch.tensor([[3, 16, -1], [0, 20, 15]], dtype=torch.int64)
    before = b2.kernel.launch_count
    rows = b2.embedding_lookup(table, ids.t())          # a strided view
    assert rows.shape == (3, 2, 8)
    torch.testing.assert_close(rows, embedding_bag_ref(
        table, ids.t().reshape(-1, 1)).reshape(3, 2, 8), rtol=0, atol=0)
    assert b2.kernel.launch_count == before
    with pytest.raises(TypeError, match="int32 or int64"):
        b2.embedding_lookup(table, ids.short())
    with pytest.raises(ValueError, match="one device"):
        b2.embedding_lookup(table, ids.to("meta"))
    with pytest.raises(ValueError, match=r"\(V, d\)"):
        b2.embedding_lookup(table[0], ids)
