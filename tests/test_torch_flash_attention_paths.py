"""Kernel B3's three paths, held on the CPU (no card needed): which path
a call takes (``b3_path``), a torch emulation of the "tc" tile loop and
of the "split" partials and their log-sum-exp combine, each against the
plain version ``attention_ref`` and the JAX package's ``mha_ref``.

The emulations follow the CUDA source's loops (csrc/flash_attention.cu):
the "tc" one walks blocks of ``TC_BLOCK_M`` (query position, q head)
rows, head fastest, two warpgroups of ``TC_WARPGROUP_ROWS`` rows each,
over ``TC_BLOCK_N``-key tiles, masks only the tiles ``tile_needs_mask``
names, keeps the running max in the log2 domain, and splits P into a
truncated bfloat16 high part and a rounded bfloat16 low part before
P·V, as the kernel does. The "split" one cuts the keys by ``split_plan``.
"""
import itertools
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro_torch.kernels.flash_attention import (attention_ref, kernel,
                                                 kv_tile_range)

from test_torch_reference import load_reference

ref_fa = load_reference("kernels.flash_attention")

# a bfloat16 output against the float32 plain version: the rounding of
# the output (2^-9 relative) and of P's low part (2^-17), the gate that
# chip_smoke.py holds the kernel to at the LM's shapes
BF16_TOL = dict(rtol=1.6e-2, atol=2e-3)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
LOG2E = 1.4426950408889634


def _inputs(seed, b, hq, hkv, sq, skv, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    return mk(b, sq, hq, d), mk(b, skv, hkv, d), mk(b, skv, hkv, d)


def _lens(kv_len, b, skv):
    if kv_len is None:
        return [skv] * b
    if isinstance(kv_len, int):
        return [min(kv_len, skv)] * b
    return [min(int(x), skv) for x in kv_len]


# ------------------------------------------------------------- b3_path
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("sq", [1, 2, 200, 2048])
def test_b3_path_for_every_dtype_and_sq(q_dtype, kv_dtype, sq):
    path = kernel.b3_path(q_dtype, kv_dtype, sq)
    if sq == 1:
        assert path == "split"
    elif q_dtype == kv_dtype == torch.bfloat16:
        assert path == "tc"
    else:
        assert path == "simt"
    assert path in kernel.PATHS


def _split_keys(skv, chunk=kernel.SPLIT_CHUNK):
    return [range(s, min(s + chunk, skv))
            for s in kernel.split_plan(skv, chunk)]


def test_split_plan_covers_every_key_once():
    for skv, chunk in [(0, 64), (1, 64), (64, 64), (65, 64), (1024, 64),
                       (130, 32)]:
        plan = _split_keys(skv, chunk)
        assert len(plan) == len(kernel.split_plan(skv, chunk)) == \
            -(-skv // chunk)
        assert [j for r in plan for j in r] == list(range(skv))
        assert all(len(r) == chunk for r in plan[:-1])


# ------------------------------------------------------ the "tc" loop
_MASK_CASES = list(itertools.product(
    [(0, 7), (8, 15), (120, 127), (3, 40)],      # (pos_lo, pos_hi)
    [0, 64, 192, 448],                           # k0
    [0, 70],                                     # q_offset
    [130, 512],                                  # kv_len
    [True, False],                               # causal
    [None, 64, 200]))                            # window


def test_tile_needs_mask_matches_brute_force():
    bn = kernel.TC_BLOCK_N
    for (lo, hi), k0, q_offset, kv_len, causal, window in _MASK_CASES:
        keys = np.arange(k0, k0 + bn)
        every = True
        for pos in range(lo, hi + 1):
            qpos = pos + q_offset
            ok = keys < kv_len
            if causal:
                ok &= keys <= qpos
            if window is not None:
                ok &= keys > qpos - window
            every &= bool(ok.all())
        assert kernel.tile_needs_mask(
            k0, lo, hi, q_offset, kv_len, causal=causal,
            window=window) == (not every), ((lo, hi), k0, q_offset, kv_len,
                                            causal, window)


def _split_p(p):
    """P as the kernel feeds it to P·V: the top 16 bits of each float32
    (a truncated bfloat16) plus the remainder rounded to bfloat16."""
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    return hi, (p - hi).to(torch.bfloat16).float()


def _emulate_tc(q, k, v, *, causal, window, kv_len):
    """The "tc" kernel's loop in torch: bfloat16 q, k, v; float32 sums."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group, q_offset = hq // hkv, skv - sq
    bm, wr, bn = (kernel.TC_BLOCK_M, kernel.TC_WARPGROUP_ROWS,
                  kernel.TC_BLOCK_N)
    scale_log2 = LOG2E / math.sqrt(d)
    out = torch.zeros(b, sq, hq, d)
    for bi, kvh in itertools.product(range(b), range(hkv)):
        kvl = _lens(kv_len, b, skv)[bi]
        kf = torch.zeros(-(-skv // bn) * bn, d)   # keys past kv_len: zeros
        vf = torch.zeros_like(kf)
        kf[:kvl] = k[bi, :kvl, kvh].float()
        vf[:kvl] = v[bi, :kvl, kvh].float()
        for row0 in range(0, sq * group, bm):
            n = min(bm, sq * group - row0)
            block = kv_tile_range(row0 // group, (row0 + n - 1) // group,
                                  q_offset, kvl, causal=causal,
                                  window=window, block_k=bn)
            for w0 in range(0, n, wr):
                rows = torch.arange(row0 + w0, row0 + min(n, w0 + wr))
                pos, heads = rows // group, kvh * group + rows % group
                lo, hi = int(pos[0]), int(pos[-1])
                mine = kv_tile_range(lo, hi, q_offset, kvl, causal=causal,
                                     window=window, block_k=bn)
                qr = q[bi, pos, heads].float()
                m = torch.full((len(rows),), -math.inf)
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), d)
                for t in block:
                    if t not in mine:
                        continue
                    keys = torch.arange(t * bn, (t + 1) * bn)
                    s = qr @ kf[keys].T
                    if kernel.tile_needs_mask(t * bn, lo, hi, q_offset, kvl,
                                              causal=causal, window=window):
                        qpos = (pos + q_offset)[:, None]
                        vis = (keys < kvl)[None, :].expand(len(rows), -1)
                        if causal:
                            vis = vis & (keys[None, :] <= qpos)
                        if window is not None:
                            vis = vis & (keys[None, :] > qpos - window)
                        s = torch.where(vis, s, torch.tensor(-math.inf))
                    m_new = torch.maximum(m, s.amax(1) * scale_log2)
                    m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                    alpha = torch.exp2(m - m_use)
                    p = torch.exp2(s * scale_log2 - m_use[:, None])
                    l = l * alpha + p.sum(1)
                    p_hi, p_lo = _split_p(p)
                    acc = acc * alpha[:, None] + p_hi @ vf[keys] \
                        + p_lo @ vf[keys]
                    m = m_new
                out[bi, pos, heads] = acc / torch.where(
                    l == 0, 1.0, l)[:, None]
    return out.to(torch.bfloat16)


TC_CASES = [  # (b, hq, hkv, sq, skv, d), window, kv_len
    ((1, 4, 4, 256, 256, 64), None, None),
    ((2, 8, 2, 128, 128, 64), None, None),     # GQA: 64 rows = 16 positions
    ((1, 4, 1, 384, 384, 128), None, None),
    ((1, 2, 2, 384, 384, 64), 64, None),
    ((1, 2, 2, 384, 384, 64), 200, None),
    ((1, 2, 2, 200, 200, 64), None, None),     # ragged rows and keys
    ((2, 4, 2, 70, 130, 32), None, None),      # q_offset 60, D 32
    ((2, 8, 1, 96, 160, 64), None, [150, 37]),   # per-row kv_len
]


@pytest.mark.parametrize("shape,window,kv_len", TC_CASES,
                         ids=[f"{c[0]}-w{c[1]}-kv{c[2]}" for c in TC_CASES])
def test_tc_loop_emulation_matches_plain_version(shape, window, kv_len):
    b, hq, hkv, sq, skv, d = shape
    q, k, v = _inputs(sum(shape), b, hq, hkv, sq, skv, d, torch.bfloat16)
    lens = None if kv_len is None else torch.tensor(kv_len)
    out = _emulate_tc(q, k, v, causal=True, window=window, kv_len=lens)
    ref = attention_ref(q.float(), k.float(), v.float(), causal=True,
                        window=window, kv_len=lens)
    torch.testing.assert_close(out.float(), ref, **BF16_TOL)


def test_tc_emulation_matches_jax_mha_ref():
    q, k, v = _inputs(7, 1, 8, 2, 130, 130, 64, torch.bfloat16)
    out = _emulate_tc(q, k, v, causal=True, window=None, kv_len=None)
    perm = (0, 2, 1, 3)
    ref = ref_fa.mha_ref(*[jnp.asarray(t.float().numpy()).transpose(perm)
                           for t in (q, k, v)], causal=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref).transpose(perm), **BF16_TOL)


# ---------------------------------------------------- the "split" path
def _emulate_split(q, k, v, *, causal, window, kv_len):
    """One query row per batch row: float32 partials (acc, m, l) of each
    split of ``split_plan`` that holds a visible key, combined by
    log-sum-exp; no split (kv_len 0) gives zeros."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    assert sq == 1
    group, qpos = hq // hkv, skv - 1
    out = torch.zeros(b, 1, hq, d)
    for bi, kvh in itertools.product(range(b), range(hkv)):
        kvl = _lens(kv_len, b, skv)[bi]
        k_end = min(kvl, qpos + 1) if causal else kvl
        k_begin = max(0, qpos - window + 1) if window is not None else 0
        heads = torch.arange(kvh * group, (kvh + 1) * group)
        qr = q[bi, 0, heads].float()
        parts = []
        for keys in _split_keys(skv):
            lo, hi = max(keys.start, k_begin), min(keys.stop, k_end)
            if lo >= hi:
                continue                     # the block exits at once
            s = qr @ k[bi, lo:hi, kvh].float().T / math.sqrt(d)
            m = s.amax(1)
            p = torch.exp(s - m[:, None])
            parts.append((p @ v[bi, lo:hi, kvh].float(), m, p.sum(1)))
        if not parts:
            continue
        mx = torch.stack([m for _, m, _ in parts]).amax(0)
        num = sum(acc * torch.exp(m - mx)[:, None] for acc, m, _ in parts)
        den = sum(l * torch.exp(m - mx) for _, m, l in parts)
        out[bi, 0, heads] = num / den[:, None]
    return out


@pytest.mark.parametrize("d", [32, 64, 128])
def test_split_emulation_matches_plain_version(d):
    chunk, skv = kernel.SPLIT_CHUNK, 300
    lens = [0, 1, chunk, chunk + 1, skv]
    q, k, v = _inputs(d, len(lens), 8, 2, 1, skv, d)
    kv_len = torch.tensor(lens)
    out = _emulate_split(q, k, v, causal=False, window=None, kv_len=kv_len)
    ref = attention_ref(q, k, v, causal=False, kv_len=kv_len)
    torch.testing.assert_close(out, ref, **F32_TOL)
    assert not out[0].any()


@pytest.mark.parametrize("causal,window,kv_len", [
    (True, None, None), (True, 70, 250), (False, 64, None), (False, 1, 129)])
def test_split_emulation_masks_like_the_plain_version(causal, window,
                                                      kv_len):
    q, k, v = _inputs(3, 2, 4, 1, 1, 300, 64)
    out = _emulate_split(q, k, v, causal=causal, window=window,
                         kv_len=kv_len)
    ref = attention_ref(q, k, v, causal=causal, window=window,
                        kv_len=kv_len)
    torch.testing.assert_close(out, ref, **F32_TOL)


def test_split_emulation_matches_jax_mha_ref():
    q, k, v = _inputs(5, 4, 8, 2, 1, 200, 64)
    lens = np.array([1, 64, 65, 200], np.int32)
    out = _emulate_split(q, k, v, causal=False, window=None,
                         kv_len=torch.from_numpy(lens))
    perm = (0, 2, 1, 3)
    ref = ref_fa.mha_ref(*[jnp.asarray(t.numpy()).transpose(perm)
                           for t in (q, k, v)], causal=False,
                         kv_len=jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).transpose(perm),
                               **F32_TOL)
