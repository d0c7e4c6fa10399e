"""Kernel B3, flash attention: the port's plain versions against the JAX
package's ``mha_ref``, ``chunked_attention`` and Pallas kernel (run in
interpret mode, as tests/test_kernels.py runs it), at the shapes and
tolerances of its ``TestFlashAttention`` (float32 2e-3, bfloat16 5e-2),
plus decode's Sq = 1 with per-batch ``kv_len``.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
What surrounds it is held here: the key-tile skip rule it computes
(``kv_tile_range``) against a brute-force mask, and a torch emulation of
its row blocks and tile loop against ``mha_ref``.
"""
import itertools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro_torch.kernels.flash_attention import (attention, attention_ref,
                                                 flash_attention_cuda, kernel,
                                                 kv_tile_range, mha_ref)
from repro_torch.models.layers import chunked_attention

from test_torch_reference import load_reference

ref_fa = load_reference("kernels.flash_attention")
ref_layers = load_reference("models.layers")

F32_TOL = dict(rtol=2e-3, atol=2e-3)      # TestFlashAttention, float32
BF16_TOL = dict(rtol=5e-2, atol=5e-2)     # TestFlashAttention, bfloat16
CAUSAL_SHAPES = [(1, 4, 4, 256, 64), (2, 8, 2, 128, 64), (1, 4, 1, 384, 128)]


def _normal(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _jax(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype=dtype)


def _bshd(seed, b, hq, hkv, sq, d, skv=None):
    """q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D) as numpy float32."""
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return (_normal(rng, (b, sq, hq, d)), _normal(rng, (b, skv, hkv, d)),
            _normal(rng, (b, skv, hkv, d)))


def _cases():
    """(id, (b, hq, hkv, s, d), window) of TestFlashAttention."""
    for shape in CAUSAL_SHAPES:
        yield f"causal{shape}", shape, None
    for window in (64, 128, 200):
        yield f"window{window}", (1, 2, 2, 384, 64), window
    yield "unpadded200", (1, 2, 2, 200, 64), None


CASES = list(_cases())


@pytest.mark.parametrize("shape,window", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_port_matches_pallas_and_mha_ref(shape, window):
    b, hq, hkv, s, d = shape
    q, k, v = _bshd(s + d, b, hq, hkv, s, d)
    pallas = np.asarray(ref_fa.attention(_jax(q), _jax(k), _jax(v),
                                         causal=True, window=window,
                                         path="pallas"))
    ref = np.asarray(ref_fa.attention(_jax(q), _jax(k), _jax(v), causal=True,
                                      window=window, path="xla"))
    out = attention(_torch(q), _torch(k), _torch(v), causal=True,
                    window=window).numpy()
    np.testing.assert_allclose(out, pallas, **F32_TOL)
    # like with like: the same float32 formula on both sides
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_bf16_matches_pallas():
    b, h, s, d = 1, 2, 256, 64
    q, k, v = _bshd(11, b, h, h, s, d)
    args = [_jax(a, jnp.bfloat16) for a in (q, k, v)]
    pallas = np.asarray(ref_fa.attention(*args, causal=True, path="pallas"),
                        np.float32)
    ref32 = np.asarray(ref_fa.attention(*[a.astype(jnp.float32)
                                          for a in args], causal=True,
                                        path="xla"))
    out = attention(*[_torch(a, torch.bfloat16) for a in (q, k, v)],
                    causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), pallas, **BF16_TOL)
    np.testing.assert_allclose(out.float().numpy(), ref32, **BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_mha_ref_matches_reference(dtype, causal, window):
    q, k, v = _bshd(5, 2, 8, 2, 96, 32, skv=128)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    perm = (0, 2, 1, 3)
    ref = ref_fa.mha_ref(*[_jax(a, jdt).transpose(perm) for a in (q, k, v)],
                         causal=causal, window=window, kv_len=120)
    out = mha_ref(*[_torch(a, tdt).permute(perm) for a in (q, k, v)],
                  causal=causal, window=window, kv_len=120)
    assert out.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_decode_shape_per_batch_kv_len(q_dtype):
    """Sq = 1 against a bfloat16 cache with per-row lengths (one of them
    0: that row is all masked and must be 0), as decode_step calls it."""
    b, hq, hkv, slots, d = 4, 8, 2, 64, 32
    q, k, v = _bshd(3, b, hq, hkv, 1, d, skv=slots)
    kv_len = np.array([1, 17, 64, 0], np.int32)
    jq = _jax(q, getattr(jnp, q_dtype))
    ref = ref_layers.dense_attention(jq, _jax(k, jnp.bfloat16),
                                     _jax(v, jnp.bfloat16), causal=False,
                                     kv_len=jnp.asarray(kv_len))
    out = attention(_torch(q, getattr(torch, q_dtype)),
                    _torch(k, torch.bfloat16), _torch(v, torch.bfloat16),
                    causal=False, kv_len=torch.from_numpy(kv_len))
    assert out.dtype == getattr(torch, q_dtype)      # promoted as mha_ref
    tol = dict(rtol=1e-5, atol=1e-5) if q_dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)
    assert not out[3].any()


@pytest.mark.parametrize("s,chunk,window", [(256, 128, None), (384, 128, 200),
                                            (256, 256, 64)])
def test_chunked_attention_matches_reference(s, chunk, window):
    q, k, v = _bshd(s, 1, 4, 2, s, 64)
    ref = ref_layers.chunked_attention(_jax(q), _jax(k), _jax(v),
                                       causal=True, window=window,
                                       chunk=chunk)
    out = chunked_attention(_torch(q), _torch(k), _torch(v), causal=True,
                            window=window, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), attention_ref(
        _torch(q), _torch(k), _torch(v), causal=True, window=window).numpy(),
        **F32_TOL)


# ---------------------------------------------------- the kernel's own rules
def _visible(pos, q_offset, kv_len, causal, window, skv):
    """Brute-force mask of one query position over keys 0..skv-1."""
    key = np.arange(skv)
    qpos = pos + q_offset
    ok = key < kv_len
    if causal:
        ok &= key <= qpos
    if window is not None:
        ok &= key > qpos - window
    return ok


_SKIP_CASES = list(itertools.product(
    [(0, 0), (0, 3), (5, 9), (31, 32), (70, 120)],      # (pos_lo, pos_hi)
    [0, 7, 64, -40],                                    # q_offset
    [0, 1, 33, 96, 500],                                # kv_len
    [True, False],                                      # causal
    [None, 1, 16, 70]))                                 # window


@pytest.mark.parametrize("rows", [_SKIP_CASES[i::4] for i in range(4)],
                         ids=["part0", "part1", "part2", "part3"])
def test_kv_tile_skip_rule_matches_brute_force(rows):
    block_k, skv = 32, 512
    for (lo, hi), q_offset, kv_len, causal, window in rows:
        any_visible = np.zeros(skv, bool)
        for pos in range(lo, hi + 1):
            any_visible |= _visible(pos, q_offset, kv_len, causal, window,
                                    skv)
        need = {j // block_k for j in np.flatnonzero(any_visible)}
        walked = set(kv_tile_range(lo, hi, q_offset, kv_len, causal=causal,
                                   window=window, block_k=block_k))
        # no visible key is skipped, and no walked tile is wholly masked
        assert walked == need, ((lo, hi), q_offset, kv_len, causal, window)


def _emulate_kernel(q, k, v, *, causal, window, kv_len):
    """The CUDA kernel's loop in torch, float32: for each (b, kv head),
    blocks of BLOCK_ROWS (query position, q head of the group) rows, head
    fastest; each block walks ``kv_tile_range`` in tiles of BLOCK_K keys
    with a running (m, l, acc), skipped rows masked as in the source."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group, q_offset = hq // hkv, skv - sq
    lens = torch.as_tensor(kv_len if kv_len is not None else skv).expand(b)
    out = torch.zeros(b, sq, hq, d)
    for bi, kvh in itertools.product(range(b), range(hkv)):
        kv = min(int(lens[bi]), skv)
        for row0 in range(0, sq * group, kernel.BLOCK_ROWS):
            rows = torch.arange(row0, min(row0 + kernel.BLOCK_ROWS,
                                          sq * group))
            pos, heads = rows // group, kvh * group + rows % group
            qr = q[bi, pos, heads].float()                  # (R, D)
            m = torch.full((len(rows),), -1e30)
            l = torch.zeros(len(rows))
            acc = torch.zeros(len(rows), d)
            for t in kv_tile_range(int(pos[0]), int(pos[-1]), q_offset, kv,
                                   causal=causal, window=window,
                                   block_k=kernel.BLOCK_K):
                keys = torch.arange(t * kernel.BLOCK_K,
                                    (t + 1) * kernel.BLOCK_K)
                live = keys < kv
                kt = torch.where(live[:, None], k[bi, keys.clamp(max=skv - 1),
                                                  kvh].float(), 0.0)
                vt = torch.where(live[:, None], v[bi, keys.clamp(max=skv - 1),
                                                  kvh].float(), 0.0)
                qpos = (pos + q_offset)[:, None]
                vis = live[None, :].expand(len(rows), -1).clone()
                if causal:
                    vis &= keys[None, :] <= qpos
                if window is not None:
                    vis &= keys[None, :] > qpos - window
                s = torch.where(vis, (qr @ kt.T) / d ** 0.5,
                                torch.tensor(-1e30))
                m_new = torch.maximum(m, s.amax(1))
                p = torch.where(vis, torch.exp(s - m_new[:, None]), 0.0)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(1)
                acc = acc * alpha[:, None] + p @ vt
                m = m_new
            out[bi, pos, heads] = acc / torch.where(l == 0, 1.0, l)[:, None]
    return out


@pytest.mark.parametrize("shape,causal,window,kv_len", [
    ((1, 4, 4, 200, 64, 200), True, None, None),
    ((2, 8, 2, 130, 32, 130), True, 48, None),
    ((1, 8, 1, 40, 128, 100), True, None, 77),       # q_offset 60
    ((3, 32, 4, 1, 64, 96), False, None, [5, 96, 0]),   # decode
])
def test_kernel_loop_emulation_matches_mha_ref(shape, causal, window, kv_len):
    b, hq, hkv, sq, d, skv = shape
    q, k, v = (_torch(a) for a in _bshd(sq + hq, b, hq, hkv, sq, d, skv=skv))
    lens = None if kv_len is None else torch.tensor(kv_len)
    emulated = _emulate_kernel(q, k, v, causal=causal, window=window,
                               kv_len=lens)
    ref = attention_ref(q, k, v, causal=causal, window=window, kv_len=lens)
    torch.testing.assert_close(emulated, ref, rtol=1e-5, atol=1e-5)


def test_wrapper_checks_and_counts_no_cpu_launch():
    q, k, v = (_torch(a) for a in _bshd(1, 1, 4, 2, 8, 32))
    before = kernel.launch_count
    out = flash_attention_cuda(q, k, v, causal=True)
    assert kernel.launch_count == before
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=True))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention_cuda(q, k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1]
                             .expand(-1, -1, 3, -1))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="bfloat16 q needs bfloat16 k"):
        flash_attention_cuda(q.bfloat16(), k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention_cuda(q, k, v, window=0)
