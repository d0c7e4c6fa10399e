"""Kernel B3-bwd, the backward of flash attention, on the CPU: its plain
version, a torch emulation of its CUDA loops, its tile skips and its
packed C arguments; and the forward's log-sum-exp.

The card runs ``csrc/flash_attention_bwd.cu`` (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 13 hold it to its plain version there). Here:

- the plain version (``attention_bwd_ref``: autograd through
  ``attention_ref`` upcast to float32) against ``jax.grad`` of the JAX
  package's ``mha_ref`` on the same inputs, within 1e-5 (float32 sums in
  two orders);
- ``lse_ref`` against the softmax it normalises, and the "tc" path's
  log2-domain formula (m · ln 2 + ln l) against it;
- ``_emulate_bwd``, the three kernels' loops in torch (the rows'
  dO·O, then dK/dV by key tile over the q tiles ``bwd_q_tile_range``
  names, then dQ by query tile over the key tiles ``kv_tile_range``
  names, at ``bwd_tiles``' sizes, P recomputed from the log-sum-exp),
  against the plain version within 1e-5 at the shapes of the JAX
  package's ``TestFlashAttention`` (head sizes 32, 64 and 128; windows;
  unpadded S; GQA; an int ``kv_len``), and bit-equal to the same loops
  walking every tile (a skipped tile adds exact zeros);
- ``_emulate_bwd_tc``, the "tc" path's walk in torch (dK/dV blocks of
  128 keys in two warpgroups of 64 over q tiles of ``bwd_tiles(d,
  "tc")["kv_rows"]`` rows; dQ blocks of 128 (query position, q head)
  rows over 64-key tiles; masks on the boundary tiles alone, whose rule
  is held to brute force on every tile), rounding what the kernels
  round: P and dS to bfloat16 for dV and dK, dS in two bfloat16 parts
  for dQ; against the plain version within ``chip_smoke.py``'s bfloat16
  gate at the same shapes, and on keys with a large common component,
  where dS in bfloat16 alone fails the gate on dQ;
- ``bwd_q_tile_range`` against brute force: a q tile is walked exactly
  when one of its rows sees one of the block's keys;
- ``bwd_launch_args`` against the source's ``enum Arg``;
- ``FlashAttention`` (the autograd wrapper) on CPU tensors, where both
  its halves are the plain versions, against plain autograd.
"""
import itertools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 attention, attention_bwd_ref,
                                                 attention_ref, kernel,
                                                 lse_ref)
from repro_torch.kernels.flash_attention.kernel import kv_tile_range

from test_torch_reference import load_reference

ref_fa = load_reference("kernels.flash_attention.ref")

TOL = dict(rtol=1e-5, atol=1e-5)
# chip_smoke.py's gate for bfloat16 B3-bwd (rtol, and atol as a fraction of
# the tensor's largest magnitude)
B3_BF16_TOL = 1.6e-2


def _inputs(seed, b, hq, hkv, sq, skv, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    return (mk(b, sq, hq, d), mk(b, skv, hkv, d), mk(b, skv, hkv, d),
            mk(b, sq, hq, d))


def _visible(sq, skv, *, causal, window, kv_len):
    q_pos = np.arange(sq)[:, None] + (skv - sq)
    k_pos = np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    if kv_len is not None:
        ok &= k_pos < kv_len
    return torch.from_numpy(ok)


def _emulate_bwd(q, k, v, do, *, causal, window, kv_len, skip=True):
    """B3-bwd's three kernels in torch, float32 sums; ``skip=False`` walks
    every tile instead of the skipped ranges."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group, q_offset = hq // hkv, skv - sq
    kvl = skv if kv_len is None else min(kv_len, skv)
    tiles = kernel.bwd_tiles(d)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    out = attention_ref(qf, kf, vf, causal=causal, window=window,
                        kv_len=kv_len)
    lse = lse_ref(qf, kf, causal=causal, window=window, kv_len=kv_len)
    delta = (dof * out).sum(-1).transpose(1, 2)           # (B, Hq, Sq)
    vis = _visible(sq, skv, causal=causal, window=window, kv_len=kv_len)

    def tile(bi, h, rows, keys):
        kvh = h // group
        s = qf[bi, rows, h] @ kf[bi, keys, kvh].T
        m = vis[rows][:, keys]
        p = torch.where(m, torch.exp(s * scale - lse[bi, h, rows, None]),
                        torch.zeros(()))
        dp = dof[bi, rows, h] @ vf[bi, keys, kvh].T
        return p, p * (dp - delta[bi, h, rows, None])

    dq, dk, dv = (torch.zeros(x.shape) for x in (q, k, v))
    c, r = tiles["kv_keys"], tiles["kv_rows"]
    for bi, kvh, k0 in itertools.product(range(b), range(hkv),
                                         range(0, skv, c)):
        keys = torch.arange(k0, min(k0 + c, skv))
        walk = (kernel.bwd_q_tile_range(k0, c, sq, q_offset, kvl,
                                        causal=causal, window=window,
                                        block_q=r)
                if skip else range(-(-sq // r)))
        for gi, t in itertools.product(range(group), walk):
            h = kvh * group + gi
            rows = torch.arange(t * r, min(t * r + r, sq))
            p, ds = tile(bi, h, rows, keys)
            dv[bi, keys, kvh] += p.T @ dof[bi, rows, h]
            dk[bi, keys, kvh] += ds.T @ qf[bi, rows, h]
    rq, cq = tiles["q_rows"], tiles["q_keys"]
    for bi, h, q0 in itertools.product(range(b), range(hq), range(0, sq, rq)):
        rows = torch.arange(q0, min(q0 + rq, sq))
        walk = (kv_tile_range(q0, int(rows[-1]), q_offset, kvl,
                              causal=causal, window=window, block_k=cq)
                if skip else range(-(-skv // cq)))
        for t in walk:
            keys = torch.arange(t * cq, min(t * cq + cq, skv))
            _, ds = tile(bi, h, rows, keys)
            dq[bi, rows, h] += ds @ kf[bi, keys, h // group]
    return dq * scale, dk * scale, dv


def _split_bf16(x):
    """x as the "tc" dQ kernel feeds it to a product: the top 16 bits of
    each float32 (a truncated bfloat16) plus the remainder rounded to
    bfloat16, summed in float32."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi + (x - hi).to(torch.bfloat16).float()


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_bwd_tc(q, k, v, do, *, causal, window, kv_len, skip=True,
                    dq_rounding=_split_bf16):
    """The "tc" path's two walks in torch: bfloat16 q, k, v and dO, float32
    sums, P and dS rounded as the kernels round them (``dq_rounding`` for
    dS in dQ's product). A tile that ``tile_needs_mask``'s rule calls full
    is asserted to be fully visible, and is then not masked. ``skip=False``
    walks every tile."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group, q_offset = hq // hkv, skv - sq
    kvl = skv if kv_len is None else min(kv_len, skv)
    tiles = kernel.bwd_tiles(d, "tc")
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    out = attention_ref(qf, kf, vf, causal=causal, window=window,
                        kv_len=kv_len)
    lse = lse_ref(qf, kf, causal=causal, window=window, kv_len=kv_len)
    delta = (dof * out).sum(-1).transpose(1, 2)           # (B, Hq, Sq)
    vis = _visible(sq, skv, causal=causal, window=window, kv_len=kv_len)
    mask = dict(causal=causal, window=window)

    def p_ds(bi, h, rows, keys, full):
        """P and dS of query rows x keys (rows past Sq are masked)."""
        kvh = h // group
        inside = rows < sq
        r = rows.clamp(max=sq - 1)
        seen = vis[r][:, keys] & inside[:, None]
        assert not full or bool(seen.all()), (bi, h, rows[0], keys[0])
        s = qf[bi, r, h] @ kf[bi, keys, kvh].T
        p = torch.exp(s * scale - lse[bi, h, r, None])
        p = p if full else torch.where(seen, p, torch.zeros(()))
        dp = dof[bi, r, h] @ vf[bi, keys, kvh].T
        return p, p * (dp - delta[bi, h, r, None]), r, inside

    dq, dk, dv = (torch.zeros(x.shape) for x in (q, k, v))
    nq, wk = tiles["kv_rows"], tiles["kv_wg_keys"]
    for bi, kvh, k0 in itertools.product(range(b), range(hkv),
                                         range(0, skv, tiles["kv_keys"])):
        block = kernel.bwd_q_tile_range(k0, tiles["kv_keys"], sq, q_offset,
                                        kvl, block_q=nq, **mask)
        for wk0 in (k0, k0 + wk):
            if wk0 >= skv:
                continue
            keys = torch.arange(wk0, min(wk0 + wk, skv))
            mine = kernel.bwd_q_tile_range(wk0, wk, sq, q_offset, kvl,
                                           block_q=nq, **mask)
            walk = ([t for t in block if t in mine] if skip
                    else range(-(-sq // nq)))
            for gi, t in itertools.product(range(group), walk):
                h, q0 = kvh * group + gi, t * nq
                full = q0 + nq <= sq and not kernel.tile_needs_mask(
                    wk0, q0, q0 + nq - 1, q_offset, kvl, **mask)
                p, ds, r, inside = p_ds(bi, h, torch.arange(q0, q0 + nq),
                                        keys, full)
                dv[bi, keys, kvh] += _bf16(p).T @ (dof[bi, r, h]
                                                   * inside[:, None])
                dk[bi, keys, kvh] += _bf16(ds).T @ (qf[bi, r, h]
                                                    * inside[:, None])
    nr, wr, nk = tiles["q_rows"], tiles["q_wg_rows"], tiles["q_keys"]
    for bi, kvh, row0 in itertools.product(range(b), range(hkv),
                                           range(0, sq * group, nr)):
        for w0 in range(row0, min(row0 + nr, sq * group), wr):
            rows = torch.arange(w0, min(w0 + wr, sq * group))
            pos, heads = rows // group, kvh * group + rows % group
            lo, hi = int(pos[0]), int(pos[-1])
            walk = (kv_tile_range(lo, hi, q_offset, kvl, block_k=nk, **mask)
                    if skip else range(-(-skv // nk)))
            acc = torch.zeros(len(rows), d)
            for t in walk:
                keys = torch.arange(t * nk, min(t * nk + nk, skv))
                full = not kernel.tile_needs_mask(t * nk, lo, hi, q_offset,
                                                  kvl, **mask)
                seen = vis[pos][:, keys]
                assert not full or bool(seen.all())
                s = (qf[bi, pos, heads] @ kf[bi, keys, kvh].T)
                p = torch.exp(s * scale - lse[bi, heads, pos, None])
                p = p if full else torch.where(seen, p, torch.zeros(()))
                dp = dof[bi, pos, heads] @ vf[bi, keys, kvh].T
                ds = p * (dp - delta[bi, heads, pos, None])
                acc += dq_rounding(ds) @ kf[bi, keys, kvh]
            dq[bi, pos, heads] = acc
    return tuple(x.to(torch.bfloat16)
                 for x in (dq * scale, dk * scale, dv))


def _gate_ratio(got, want):
    """The largest |got - want| / (1.6e-2 |want| + 1.6e-2 max|want|):
    ``chip_smoke.py``'s bfloat16 gate for B3-bwd passes at <= 1."""
    gap = (got.float() - want).abs()
    return float((gap / (B3_BF16_TOL * want.abs()
                         + B3_BF16_TOL * want.abs().max())).max())


# the JAX package's TestFlashAttention cases, and its windowed, unpadded
# and GQA ones; head sizes 32, 64 and 128
SHAPES = [(1, 4, 4, 256, 64), (2, 8, 2, 128, 64), (1, 4, 1, 384, 128),
          (1, 2, 2, 96, 32)]
MASKS = [dict(causal=True, window=None, kv_len=None),
         dict(causal=True, window=64, kv_len=None),
         dict(causal=True, window=128, kv_len=None),
         dict(causal=True, window=200, kv_len=None),
         dict(causal=False, window=None, kv_len=None),
         dict(causal=True, window=None, kv_len=150)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_emulated_loops_match_plain_version(shape):
    b, hq, hkv, s, d = shape
    q, k, v, do = _inputs(sum(shape), b, hq, hkv, s, s, d)
    for mask in MASKS:
        want = attention_bwd_ref(q, k, v, do, **mask)
        got = _emulate_bwd(q, k, v, do, **mask)
        for name, g, w in zip("qkv", got, want):
            torch.testing.assert_close(g, w, **TOL,
                                       msg=lambda m: f"d{name} {mask}: {m}")


@pytest.mark.parametrize("sq,skv,mask", [
    (200, 200, dict(causal=True, window=None, kv_len=None)),
    (200, 200, dict(causal=True, window=64, kv_len=None)),
    (70, 200, dict(causal=True, window=None, kv_len=None)),
    (70, 200, dict(causal=True, window=100, kv_len=180)),
    (130, 90, dict(causal=False, window=None, kv_len=None))])
def test_emulated_tile_skips_add_exact_zeros(sq, skv, mask):
    """Unpadded and Sq != Skv (q_offset != 0): the skipping walk equals
    the walk over every tile bit for bit, and both the plain version."""
    q, k, v, do = _inputs(sq + skv, 2, 4, 2, sq, skv, 64)
    skipped = _emulate_bwd(q, k, v, do, **mask)
    full = _emulate_bwd(q, k, v, do, skip=False, **mask)
    want = attention_bwd_ref(q, k, v, do, **mask)
    for g, f, w in zip(skipped, full, want):
        assert torch.equal(g, f)
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tc_emulation_matches_plain_version(shape):
    """The "tc" walk with the kernels' roundings, bfloat16 inputs, within
    the bfloat16 gate of the plain version on the same inputs in
    float32."""
    b, hq, hkv, s, d = shape
    q, k, v, do = _inputs(sum(shape) + 1, b, hq, hkv, s, s, d,
                          dtype=torch.bfloat16)
    for mask in MASKS:
        want = attention_bwd_ref(*(x.float() for x in (q, k, v, do)), **mask)
        got = _emulate_bwd_tc(q, k, v, do, **mask)
        for name, g, w in zip("qkv", got, want):
            assert g.dtype == torch.bfloat16
            assert _gate_ratio(g, w) <= 1.0, (name, mask, _gate_ratio(g, w))


@pytest.mark.parametrize("sq,skv,mask", [
    (200, 200, dict(causal=True, window=None, kv_len=None)),
    (70, 200, dict(causal=True, window=100, kv_len=180)),
    (130, 90, dict(causal=False, window=None, kv_len=None))])
def test_tc_emulated_tile_skips_add_exact_zeros(sq, skv, mask):
    """The "tc" walks over the skipped ranges equal the walks over every
    tile (a masked tile's P and dS are exact zeros in bfloat16)."""
    q, k, v, do = _inputs(sq * skv, 2, 4, 2, sq, skv, 64,
                          dtype=torch.bfloat16)
    skipped = _emulate_bwd_tc(q, k, v, do, **mask)
    full = _emulate_bwd_tc(q, k, v, do, skip=False, **mask)
    for g, f in zip(skipped, full):
        assert torch.equal(g, f)


@pytest.mark.parametrize("d", kernel.HEAD_DIMS)
def test_tc_rounding_survives_a_common_key_component(d):
    """The softmax-identity trap: keys sharing a large component make dQ
    a difference of nearly equal terms. dS in two bfloat16 parts (what
    the dQ kernel ships) keeps Σ_j dS[i, j] = 0 and dQ inside the gate;
    dS in bfloat16 alone breaks it by ~2^-9·‖dS_i‖ a row, which the
    common component multiplies past the gate. dK and dV, from one
    bfloat16 part, stay inside it either way."""
    q, k, v, do = _inputs(12 + d, 1, 8, 2, 256, 256, d, dtype=torch.bfloat16)
    k = (k.float() * 0.05 + 3.0).to(torch.bfloat16)
    mask = dict(causal=True, window=None, kv_len=None)
    want = attention_bwd_ref(*(x.float() for x in (q, k, v, do)), **mask)
    shipped = _emulate_bwd_tc(q, k, v, do, **mask)
    alone = _emulate_bwd_tc(q, k, v, do, dq_rounding=_bf16, **mask)
    ratios = [_gate_ratio(g, w) for g, w in zip(shipped, want)]
    assert max(ratios) <= 1.0, ratios
    assert _gate_ratio(alone[0], want[0]) > 1.0
    for g, w in zip(alone[1:], want[1:]):
        assert _gate_ratio(g, w) <= 1.0


def test_b3_bwd_path_is_the_dtype():
    assert kernel.b3_bwd_path(torch.bfloat16) == "tc"
    assert kernel.b3_bwd_path(torch.float32) == "simt"
    assert set(kernel.bwd_launch_counts) == set(kernel.BWD_PATHS)


def test_bwd_q_tile_range_matches_brute_force():
    for (k0, n, sq, q_offset, kv_len, causal, window,
         block_q) in itertools.product(
            [0, 32, 64, 192], [32, 64, 128], [64, 200], [0, 70], [130, 270],
            [True, False], [None, 50, 128], [32, 64]):
        skv = sq + q_offset
        if k0 >= skv:
            continue
        vis = _visible(sq, skv, causal=causal, window=window,
                       kv_len=kv_len).numpy()
        cols = vis[:, k0:min(k0 + n, skv)]
        want = [t for t in range(-(-sq // block_q))
                if cols[t * block_q:(t + 1) * block_q].any()]
        got = list(kernel.bwd_q_tile_range(
            k0, n, sq, q_offset, min(kv_len, skv), causal=causal,
            window=window, block_q=block_q))
        assert got == want, (k0, n, sq, q_offset, kv_len, causal, window)


def test_bwd_tiles_match_the_source():
    src = kernel.BWD_SOURCE.read_text()
    assert "static constexpr int C = D == 128 ? 32 : 64;" in src
    assert "static constexpr int R = D == 128 ? 32 : 64;" in src
    assert "static constexpr int R = 2048 / C;" in src
    assert "static constexpr int C = 2048 / R;" in src
    for d in kernel.HEAD_DIMS:
        t = kernel.bwd_tiles(d)
        assert t["kv_keys"] * t["kv_rows"] == t["q_rows"] * t["q_keys"] == 2048
        # every thread of 128 owns whole float4 groups in both sums
        assert t["kv_keys"] * d % (512 * 4) == 0
        assert t["q_rows"] * d % (512 * 4) == 0
    # "tc": tc::Cfg and the block constants
    for line in ("constexpr int kWGs = 2;",
                 "constexpr int kKeys = 64;",
                 "constexpr int kBlockKeys = kKeys * kWGs;",
                 "constexpr int kWGRows = 64;",
                 "constexpr int kRows = kWGRows * kWGs;",
                 "static constexpr int kQRows = D == 128 ? 32 : 64;"):
        assert line in src, line
    for d in kernel.HEAD_DIMS:
        t = kernel.bwd_tiles(d, "tc")
        assert (t["kv_keys"], t["kv_wg_keys"]) == (128, 64)
        assert (t["q_rows"], t["q_wg_rows"], t["q_keys"]) == (128, 64, 64)
        assert t["kv_rows"] == (32 if d == 128 else 64)
        # a k16 step of wgmma over q rows, and whole 8-row groups
        assert t["kv_rows"] % 16 == 0


def test_plain_backward_matches_jax_mha_ref():
    q, k, v, do = _inputs(3, 2, 8, 2, 96, 96, 32)
    for mask in MASKS[:2] + MASKS[-1:]:
        want = jax.grad(lambda qq, kk, vv: jnp.sum(ref_fa.mha_ref(
            qq, kk, vv, causal=mask["causal"], window=mask["window"],
            kv_len=mask["kv_len"]) * jnp.asarray(
                do.transpose(1, 2).numpy())), argnums=(0, 1, 2))(
            *(jnp.asarray(x.transpose(1, 2).numpy()) for x in (q, k, v)))
        got = attention_bwd_ref(q, k, v, do, **mask)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(),
                                       np.asarray(w).transpose(0, 2, 1, 3),
                                       **TOL)


def test_plain_backward_keeps_the_inputs_dtype():
    q, k, v, do = _inputs(4, 1, 4, 2, 64, 64, 64, dtype=torch.bfloat16)
    grads = attention_bwd_ref(q, k, v, do, causal=True)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    want = attention_bwd_ref(q.float(), k.float(), v.float(), do.float(),
                             causal=True)
    for g, w in zip(grads, want):
        assert torch.equal(g, w.to(torch.bfloat16))


@pytest.mark.parametrize("mask", MASKS, ids=str)
def test_lse_is_the_softmax_normaliser(mask):
    q, k, v, _ = _inputs(5, 1, 4, 2, 80, 80, 64)
    lse = lse_ref(q, k, **mask)                        # (B, Hq, Sq)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2)) / 8.0
    vis = _visible(80, 80, **mask)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros(()))
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.repeat_interleave(2, 2))
    torch.testing.assert_close(o, attention_ref(q, k, v, **mask), **TOL)
    torch.testing.assert_close(p.sum(-1)[vis.any(-1).expand_as(lse)],
                               torch.ones(()).expand(int(
                                   vis.any(-1).sum() * 4)), **TOL)


def test_lse_of_a_row_without_keys_is_inf():
    q, k, _, _ = _inputs(6, 1, 2, 2, 8, 8, 32)
    lse = lse_ref(q, k, causal=True, kv_len=0)
    assert torch.isinf(lse).all() and (lse > 0).all()


def test_tc_lse_formula_from_its_log2_state():
    """"tc" keeps the row max m in the log2 domain of the scaled scores
    and the sum l of 2^(s·scale·log2 e − m) over tiles of 64 keys; it
    stores m · ln 2 + ln l."""
    q, k, _, _ = _inputs(7, 1, 2, 2, 130, 130, 64)
    scale_log2 = 1.4426950408889634 / 8.0
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale_log2
    s = s.masked_fill(~_visible(130, 130, causal=True, window=None,
                                kv_len=None), -math.inf)
    m = torch.full(s.shape[:-1], -math.inf)
    l = torch.zeros(s.shape[:-1])
    for k0 in range(0, 130, kernel.TC_BLOCK_N):
        t = s[..., k0:k0 + kernel.TC_BLOCK_N]
        m_new = torch.maximum(m, t.amax(-1))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        l = l * torch.exp2(m - m_use) + torch.exp2(t - m_use[..., None]).sum(-1)
        m = m_new
    lse = m * 0.6931471805599453 + torch.log(l)
    torch.testing.assert_close(lse, lse_ref(q, k, causal=True), **TOL)


def test_forward_for_backward_on_the_cpu():
    q, k, v, _ = _inputs(8, 2, 4, 2, 40, 40, 32)
    out, lse, o32 = kernel.flash_attention_cuda(q, k, v, causal=True,
                                                window=16, for_backward=True)
    assert torch.equal(out, attention_ref(q, k, v, causal=True, window=16))
    assert torch.equal(lse, lse_ref(q, k, causal=True, window=16))
    assert o32.dtype == torch.float32 and torch.equal(o32, out)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    out, _, o32 = kernel.flash_attention_cuda(qb, kb, vb, causal=True,
                                              for_backward=True)
    assert out.dtype == torch.bfloat16 and o32.dtype == torch.float32
    assert torch.equal(o32, attention_ref(qb.float(), kb.float(), vb.float(),
                                          causal=True))
    with pytest.raises(ValueError, match="Sq > 1"):
        kernel.flash_attention_cuda(q[:, :1], k, v, causal=False,
                                    for_backward=True)


def test_delta_from_a_rounded_output_breaks_the_softmax_identity():
    """Why the backward reads the float32 output: Σ_j dS[i, j] is 0 when
    delta_i = dO_i · O_i with O the exact output, and dQ then ignores a
    component common to every key; from the bfloat16 O the sum is off by
    ~2^-9 of delta, which a large common key component multiplies."""
    q, k, v, do = _inputs(11, 1, 4, 2, 128, 128, 64)
    k = k * 0.05 + 3.0                          # a large common component
    out = attention_ref(q, k, v, causal=True)
    lse = lse_ref(q, k, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2)) / 8.0
    vis = _visible(128, 128, causal=True, window=None, kv_len=None)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros(()))
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.repeat_interleave(2, 2))
    want = attention_bwd_ref(q, k, v, do, causal=True)[0]
    errs = []
    for o in (out, out.bfloat16().float()):
        delta = (do * o).sum(-1).transpose(1, 2)
        ds = p * (dp - delta[..., None])
        dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                          k.repeat_interleave(2, 2)) / 8.0
        errs.append(float((dq - want).norm() / want.norm()))
    assert errs[0] < 1e-4 < 1e-2 < errs[1], errs


def _enum_args(source) -> list[str]:
    body = re.search(r"enum Arg \{(.*?)\};", source.read_text(), re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"\bk(\w+)\b", body)
    return [n.lower() for n in names if n != "NumArgs"]


def test_packed_arguments_are_the_c_sides_in_its_order():
    assert _enum_args(kernel.BWD_SOURCE) == [
        n.replace("_", "").lower() for n in kernel.BWD_ARGS.names]
    q, k, v, do = _inputs(9, 2, 8, 2, 48, 64, 64)
    o = torch.empty_like(q)
    lse = torch.empty(2, 8, 48)
    delta = torch.empty(2, 8, 48)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)   # a strided view
    got = kernel.BWD_ARGS.unpack(kernel.bwd_launch_args(
        q, kt, v, o, lse, do, delta, dq, dk, dv, causal=True, window=32,
        kv_len=100))
    assert got == dict(
        bf16=0, head_dim=64, q=q.data_ptr(), q_sb=48 * 8 * 64, q_ss=8 * 64,
        q_sh=64, k=kt.data_ptr(), k_sb=64 * 2 * 64, k_ss=64, k_sh=64 * 64,
        v=v.data_ptr(), v_sb=64 * 2 * 64, v_ss=2 * 64, v_sh=64,
        o=o.data_ptr(), o_sb=48 * 8 * 64, o_ss=8 * 64, o_sh=64,
        do=do.data_ptr(), do_sb=48 * 8 * 64, do_ss=8 * 64, do_sh=64,
        lse=lse.data_ptr(), delta=delta.data_ptr(), dq=dq.data_ptr(),
        dk=dk.data_ptr(), dv=dv.data_ptr(), B=2, Sq=48, Skv=64, Hq=8, Hkv=2,
        causal=1, window=32, kv_len=64)


def test_bwd_bound_counts_visible_pairs():
    q = torch.empty(2, 100, 4, 32)
    k = torch.empty(2, 100, 2, 32)
    for causal, window in ((True, None), (True, 30), (False, None)):
        pairs, ops = kernel.bwd_bound(q, k, causal=causal, window=window)
        want = int(_visible(100, 100, causal=causal, window=window,
                            kv_len=None).sum()) * 2 * 4
        assert pairs == want and ops == 10 * 32 * want
    # tinyllama's training microbatch: the 0.695 ms of the issue
    pairs, ops = kernel.bwd_bound(torch.empty(4, 4096, 32, 64),
                                  torch.empty(4, 4096, 4, 64), causal=True,
                                  window=None)
    assert pairs == 4 * 32 * 4096 * 4097 // 2
    assert ops / 989e12 * 1e3 == pytest.approx(0.695, abs=1e-3)


def test_autograd_wrapper_on_cpu_tensors_is_plain_autograd():
    q, k, v, do = _inputs(10, 1, 4, 2, 64, 64, 32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = FlashAttention.apply(*leaves, True, 24, None)
    got = torch.autograd.grad(out, leaves, do)
    want = attention_bwd_ref(q, k, v, do, causal=True, window=24)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # ``attention`` on CPU tensors: the plain forward, differentiated
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention(*leaves, causal=True, window=24)
    assert out.grad_fn is not None
    for g, w in zip(torch.autograd.grad(out, leaves, do), want):
        torch.testing.assert_close(g, w, **TOL)
