"""Flash attention (kernel B3) and its backward (B3-bwd) as CUDA kernels
written for Hopper.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.
The source is ``repro_torch/csrc/flash_attention.cu``; ``kernels/_build.py``
compiles it with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, and it is bound with ``ctypes``.

Three paths, chosen by ``b3_path`` from dtype and shape alone (the
source note in the ``.cu`` file has their designs):

- ``"tc"``: q, k and v bfloat16 with Sq > 1 (prefill, ``forward``).
  Bound by operations (4·D per visible (query, key) pair) at the tensor
  cores' bfloat16 rate: wgmma products over a cp.async ring of K/V tiles,
  the online softmax in registers.
- ``"split"``: Sq == 1 (decode), every dtype pair. Bound by the bytes of
  the live K and V rows: one block per 64 keys (``split_plan``) writes
  float32 partials to a scratch tensor, a second kernel combines them by
  log-sum-exp. Two kernels per call.
- ``"simt"``: float32 q with Sq > 1 (the float32-parameter runs, which
  tensor cores would round to TF32): the first version, on the float32
  cores.

Every path shares each K/V tile among the q heads of a GQA group, skips
the key tiles no row can see (``kv_tile_range``), and reads q, k and v
through their strides in the (B, S, H, D) layout of the model and the KV
cache, which is therefore never transposed or copied.

``flash_attention_cuda`` launches the kernel for CUDA tensors and raises
on what it cannot take; for CPU tensors it computes the plain version
(``ref.attention_ref``). There is no other fallback. With
``for_backward=True`` ("tc" and "simt" only) it also returns what the
backward reads: each row's log-sum-exp and the output in float32 before
its rounding to bfloat16.

B3-bwd (``flash_attention_bwd_cuda``, source
``repro_torch/csrc/flash_attention_bwd.cu``, its own library) is the
gradient of the forward with respect to q, k and v: three kernels (the
rows' ``dO . O``, then dK and dV by key tile, then dQ by query tile),
each output row summed by one block in a fixed order, so no atomics and
the same bits every run. Two paths, chosen by ``b3_bwd_path`` from the
dtype alone: ``"tc"`` for bfloat16 (wgmma on the tensor cores) and
``"simt"`` for float32 (the float32 cores, which keep its precision).
It replaces no Pallas kernel (the JAX package differentiates its XLA
attention); ``ops.attention`` reaches it through a
``torch.autograd.Function`` when an input requires a gradient. Its plain
version is autograd through ``ref.attention_ref``
(``ref.attention_bwd_ref``).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from .. import _build, _launch
from .ref import attention_bwd_ref, attention_ref, lse_ref

SOURCE = _build.CSRC / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128)
PATHS = ("simt", "tc", "split")   # their codes in the C interface
# "simt": (query, q head) rows per block and keys per tile (simt::kRows,
# simt::kBlockK in the source)
BLOCK_ROWS = 16
BLOCK_K = 32
# "tc": rows per block, per consumer warpgroup, and keys per tile
# (tc::kRows, tc::kWGRows, tc::kKeys)
TC_BLOCK_M = 128
TC_WARPGROUP_ROWS = 64
TC_BLOCK_N = 64
# "split": keys per split (split::kChunk)
SPLIT_CHUNK = 64

# Calls of ``flash_attention_cuda`` that launched on the card in this
# process (CPU calls of the plain version do not count), in all and per
# path; a "split" call launches two kernels. Reset by assigning 0 and
# ``dict.fromkeys(PATHS, 0)``.
launch_count = 0
launch_counts = dict.fromkeys(PATHS, 0)
# What the last build did: seconds spent in nvcc (0.0 when the library
# was already built) and the compiler's report (registers, spills).
build_seconds = 0.0
build_log = ""

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# ``flash_attention_fwd``'s C signature (the two pointers before the
# stream are the optional log-sum-exp and float32 outputs)
FWD_ARGTYPES = ([_I32] * 4 + [_PTR] * 4 + [_I32] * 5 + [_I64] * 12
                + [_I32] * 3
                + [_PTR, ctypes.c_float, _PTR, _I32, _PTR, _PTR, _PTR])

_lib = None


def load_library() -> ctypes.CDLL:
    """Build (once per source hash, ``kernels/_build.py``) and load the
    kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, built = _build.load(SOURCE)
    build_seconds, build_log = built.seconds, built.log
    lib.flash_attention_fwd.argtypes = FWD_ARGTYPES
    lib.flash_attention_fwd.restype = _I32
    _lib = lib
    return lib


def kv_tile_range(pos_lo: int, pos_hi: int, q_offset: int, kv_len: int, *,
                  causal: bool, window: int | None,
                  block_k: int = BLOCK_K) -> range:
    """The key tiles a block whose rows hold the query positions
    ``pos_lo..pos_hi`` walks; every other tile is wholly masked for those
    rows (the TPU kernel's ``pl.when`` skip). The kernel computes the
    same rule."""
    k_end = kv_len
    if causal:
        k_end = min(k_end, pos_hi + q_offset + 1)
    k_begin = 0
    if window is not None:
        k_begin = max(0, pos_lo + q_offset - window + 1)
    if k_end <= k_begin:
        return range(0)
    return range(k_begin // block_k, -(-k_end // block_k))


def b3_path(q_dtype: torch.dtype, kv_dtype: torch.dtype, sq: int) -> str:
    """The kernel path for these inputs: "split" for one query row per
    batch row (decode), "tc" for bfloat16 q, k and v, else "simt". A pure
    function of dtype and shape; not a fallback."""
    if sq == 1:
        return "split"
    if q_dtype == kv_dtype == torch.bfloat16:
        return "tc"
    return "simt"


def split_plan(skv: int, chunk: int = SPLIT_CHUNK) -> range:
    """The first key of each split of the "split" path; a split holds
    keys ``start .. min(start + chunk, skv) - 1``. Its length is the
    grid's first dimension."""
    return range(0, skv, chunk)


def tile_needs_mask(k0: int, pos_lo: int, pos_hi: int, q_offset: int,
                    kv_len: int, *, causal: bool, window: int | None,
                    block_n: int = TC_BLOCK_N) -> bool:
    """Whether some query position in ``pos_lo..pos_hi`` cannot see every
    key of the tile starting at ``k0``: the "tc" path masks only such
    boundary tiles (``tc::needs_mask`` in the source is the same rule)."""
    full = k0 + block_n <= kv_len
    if causal:
        full = full and k0 + block_n - 1 <= pos_lo + q_offset
    if window is not None:
        full = full and k0 > pos_hi + q_offset - window
    return not full


@functools.cache
def _check_hopper(device: torch.device) -> None:
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError(
            "the flash attention kernel is built for sm_90a (Hopper); "
            f"device {torch.cuda.get_device_name(device)} has compute "
            f"capability {torch.cuda.get_device_capability(device)}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head size")
    if k.shape[2] < 1 or hq % k.shape[2] != 0:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[2]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16; got "
                            f"{t.dtype}")
    if k.dtype != v.dtype:
        raise TypeError(f"k and v must share a dtype; got {k.dtype} and "
                        f"{v.dtype}")
    if q.dtype == torch.bfloat16 and k.dtype == torch.float32:
        raise TypeError("a bfloat16 q needs bfloat16 k and v; got float32")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k and v must share one device; got {q.device}, "
                         f"{k.device}, {v.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         kv_len: int | torch.Tensor | None = None,
                         for_backward: bool = False):
    """q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    The counterpart of the JAX package's ``flash_attention_pallas`` in
    the model's layout, without block padding: ``kv_len`` is None (all
    ``Skv`` keys), an int, or a (B,) integer tensor of per-row lengths
    (the decode path). The output is bfloat16 when q, k and v are, else
    float32, as ``mha_ref`` promotes. CUDA tensors go to the kernel (or
    raise); CPU tensors go to the plain version.

    ``for_backward=True`` returns (output, lse, o32), what B3-bwd reads:
    lse (B, Hq, Sq) float32, each row's log-sum-exp of its scaled scores
    (+inf where a row sees no key), and o32 the output in float32 before
    its rounding (the output itself when it is float32), both written by
    the "tc" and "simt" paths in the same launch; the "split" path
    (Sq = 1) refuses it.
    """
    global launch_count
    _check(q, k, v, window)
    if for_backward and q.shape[1] == 1:
        raise ValueError("for_backward needs Sq > 1: the decode path "
                         "(\"split\") writes no log-sum-exp")
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, causal=causal, window=window,
                            kv_len=kv_len)
        if for_backward:
            o32 = attention_ref(q.float(), k.float(), v.float(),
                                causal=causal, window=window, kv_len=kv_len)
            return out, lse_ref(q, k, causal=causal, window=window,
                                kv_len=kv_len), o32
        return out
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_hopper(q.device)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} is not one of {HEAD_DIMS}")
    if max(b, hkv) > 65535 or max(sq * (hq // hkv), skv) >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: B={b}, Sq={sq}, "
                         f"Skv={skv}, Hq={hq}, Hkv={hkv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous last dimension")
    lens, kv_scalar = None, skv
    if isinstance(kv_len, torch.Tensor) and kv_len.dim() > 0:
        if kv_len.shape != (b,):
            raise ValueError(f"kv_len must be (B,) = ({b},); got "
                             f"{tuple(kv_len.shape)}")
        lens = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    elif kv_len is not None:
        kv_scalar = int(kv_len)
    both_bf16 = q.dtype == k.dtype == torch.bfloat16
    out = torch.empty((b, sq, hq, d), device=q.device,
                      dtype=torch.bfloat16 if both_bf16 else torch.float32)
    path = b3_path(q.dtype, k.dtype, sq)
    lse = o32 = None
    if for_backward:
        lse = torch.empty((b, hq, sq), device=q.device, dtype=torch.float32)
        o32 = (torch.empty((b, sq, hq, d), device=q.device,
                           dtype=torch.float32) if path == "tc" else out)
    scratch, n_splits = None, 0
    if path == "split":
        # float32 partials of every split: acc (group, D), m and l (group)
        n_splits = len(split_plan(skv))
        scratch = torch.empty(b * hkv * n_splits * (hq // hkv) * (d + 2),
                              device=q.device, dtype=torch.float32)
    lib = load_library()
    # the launch goes to the calling thread's current device
    guard = (contextlib.nullcontext()
             if q.device.index == torch.cuda.current_device()
             else torch.cuda.device(q.device))
    with guard:
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            PATHS.index(path), int(q.dtype == torch.bfloat16),
            int(k.dtype == torch.bfloat16), d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, hq, hkv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            int(causal), window or 0, kv_scalar,
            None if lens is None else lens.data_ptr(), 1.0 / math.sqrt(d),
            None if scratch is None else scratch.data_ptr(), n_splits,
            None if lse is None else lse.data_ptr(),
            o32.data_ptr() if path == "tc" and for_backward else None, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed (path "
                           f"{path!r}): CUDA error {err}")
    launch_count += 1
    launch_counts[path] += 1
    return (out, lse, o32) if for_backward else out


# ------------------------------------------------------------- B3-bwd
BWD_SOURCE = _build.CSRC / "flash_attention_bwd.cu"
# the source's ``enum Arg``, in order
BWD_ARGS = _launch.Args(
    "bf16", "head_dim", "q", "q_sb", "q_ss", "q_sh", "k", "k_sb", "k_ss",
    "k_sh", "v", "v_sb", "v_ss", "v_sh", "o", "o_sb", "o_ss", "o_sh", "do",
    "do_sb", "do_ss", "do_sh", "lse", "delta", "dq", "dk", "dv", "B", "Sq",
    "Skv", "Hq", "Hkv", "causal", "window", "kv_len")
BWD_PATHS = ("simt", "tc")
# Calls of ``flash_attention_bwd_cuda`` that launched on the card (three
# kernels each), in all and per path; CPU calls of the plain version do
# not count. Reset by assigning 0 and ``dict.fromkeys(BWD_PATHS, 0)``.
bwd_launch_count = 0
bwd_launch_counts = dict.fromkeys(BWD_PATHS, 0)
_bwd_lib = None


def load_bwd_library() -> ctypes.CDLL:
    """Build (once per source hash) and load B3-bwd's library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib, _ = _build.load(BWD_SOURCE)
        lib.flash_attention_bwd.argtypes = [_PTR, ctypes.c_float, _PTR]
        lib.flash_attention_bwd.restype = _I32
        _bwd_lib = lib
    return _bwd_lib


def b3_bwd_path(dtype: torch.dtype) -> str:
    """B3-bwd's path for inputs of this dtype: "tc" (wgmma) for bfloat16,
    "simt" for float32, which tensor cores would round to TF32. A pure
    function of dtype; not a fallback."""
    return "tc" if dtype == torch.bfloat16 else "simt"


def bwd_tiles(head_dim: int, path: str = "simt") -> dict[str, int]:
    """B3-bwd's tiles at head size ``head_dim``: ``kv_keys`` keys a dK/dV
    block owns, ``kv_rows`` query rows (of one q head) a tile of its walk;
    ``q_rows`` rows a dQ block owns, ``q_keys`` keys a tile of its walk.
    "simt" (``KvCfg``/``QCfg`` in the source); "tc" (``tc::Cfg``) adds
    ``kv_wg_keys`` and ``q_wg_rows``, a warpgroup's share of a block, and
    its dQ rows are (query position, q head of the group) pairs, head
    fastest, as the forward's."""
    if path == "tc":
        return {"kv_keys": 128, "kv_wg_keys": 64,
                "kv_rows": 32 if head_dim == 128 else 64,
                "q_rows": 128, "q_wg_rows": 64, "q_keys": 64}
    kv_keys = 32 if head_dim == 128 else 64
    q_rows = 32 if head_dim == 128 else 64
    return {"kv_keys": kv_keys, "kv_rows": 2048 // kv_keys,
            "q_rows": q_rows, "q_keys": 2048 // q_rows}


def bwd_q_tile_range(k0: int, n_keys: int, sq: int, q_offset: int,
                     kv_len: int, *, causal: bool, window: int | None,
                     block_q: int) -> range:
    """The query tiles (of ``block_q`` rows) that a dK/dV block owning keys
    ``k0 .. k0 + n_keys - 1`` walks: those holding a row that sees one of
    its keys. The source's ``dkv_kernel`` computes the same rule; every
    other tile is wholly masked for these keys."""
    k_last = min(k0 + n_keys, kv_len) - 1
    if k_last < k0:
        return range(0)
    i_lo = max(0, k0 - q_offset) if causal else 0
    i_hi = min(sq, k_last + window - q_offset) if window is not None else sq
    if i_hi <= i_lo:
        return range(0)
    return range(i_lo // block_q, -(-i_hi // block_q))


def bwd_bound(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
              window: int | None) -> tuple[int, int]:
    """(visible (query, q head, key) triples, operations) of B3-bwd on
    these shapes: 10·D operations a visible pair (S, dP, dV, dK and dQ,
    two each per element of D), the work a backward must do whatever it
    recomputes. The kernels do more: "simt" 14·D (S and dP in both of
    its kernels), "tc" 16·D (and dQ's product twice, for dS in two
    bfloat16 parts)."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    q_offset = skv - sq
    pos = torch.arange(sq, dtype=torch.int64) + q_offset
    hi = torch.minimum(pos + 1, torch.tensor(skv)) if causal else \
        torch.full_like(pos, skv)
    lo = (pos - window + 1).clamp(min=0) if window is not None else \
        torch.zeros_like(pos)
    pairs = int((hi - lo).clamp(min=0).sum()) * b * hq
    return pairs, 10 * d * pairs


def bwd_launch_args(q, k, v, o, lse, do, delta, dq, dk, dv, *, causal,
                    window, kv_len) -> bytes:
    """B3-bwd's packed C arguments (``BWD_ARGS``, the source's ``enum
    Arg``) for these tensors: pointers and strides in elements; dq, dk and
    dv contiguous; ``kv_len`` None (every key) or an int, clamped to
    [0, Skv]."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kv = skv if kv_len is None else max(0, min(int(kv_len), skv))
    return BWD_ARGS.pack(
        int(q.dtype == torch.bfloat16), d,
        q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3], o.data_ptr(), *o.stride()[:3],
        do.data_ptr(), *do.stride()[:3], lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq, hkv,
        int(causal), window or 0, kv)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             kv_len: int | None = None):
    """The gradient of ``flash_attention_cuda(q, k, v, ...)`` for the
    output gradient ``do``, given the forward's float32 output ``o`` and
    ``lse`` (``for_backward=True``): (dq, dk, dv) in the shapes and dtypes
    of q, k, v. q, k, v and do all float32 or all bfloat16; ``kv_len``
    None or an int (per-row lengths are a decode feature and raise). CUDA
    tensors go to B3-bwd through the path ``b3_bwd_path`` names (or
    raise); CPU tensors go to the plain version, autograd through
    ``attention_ref`` upcast to float32 (``o`` and ``lse`` unused
    there)."""
    global bwd_launch_count
    _check(q, k, v, window)
    if isinstance(kv_len, torch.Tensor):
        raise NotImplementedError("B3-bwd takes kv_len None or an int; per-row "
                                  "lengths are a decode feature")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, do, causal=causal, window=window,
                                 kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _launch.check_hopper(q.device, "flash attention backward")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dtypes = {t.dtype for t in (q, k, v, do)}
    if len(dtypes) != 1 or o.dtype != torch.float32:
        raise TypeError("B3-bwd takes q, k, v and do of one dtype and a "
                        f"float32 o; got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{do.dtype} and {o.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} is not one of {HEAD_DIMS}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous float32 ({b}, {hq}, {sq}) "
                         f"tensor on {q.device}")
    if max(b, hq) > 65535 or max(sq, skv) >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: B={b}, Sq={sq}, "
                         f"Skv={skv}, Hq={hq}")
    do = do if do.stride(3) == 1 else do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous last dimension")
    empty = sq == 0 or skv == 0 or b == 0
    make = torch.zeros if empty else torch.empty
    dq = make(q.shape, device=q.device, dtype=q.dtype)
    dk = make(k.shape, device=q.device, dtype=k.dtype)
    dv = make(v.shape, device=q.device, dtype=v.dtype)
    if empty:
        return dq, dk, dv
    delta = torch.empty((b, hq, sq), device=q.device, dtype=torch.float32)
    args = bwd_launch_args(q, k, v, o, lse, do, delta, dq, dk, dv,
                           causal=causal, window=window, kv_len=kv_len)
    lib = load_bwd_library()
    with _launch.device_guard(q.device):
        err = lib.flash_attention_bwd(args, 1.0 / math.sqrt(d),
                                      _launch.raw_stream(q.device))
    path = b3_bwd_path(q.dtype)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed (path "
                           f"{path!r}): CUDA error {err}")
    bwd_launch_count += 1
    bwd_launch_counts[path] += 1
    return dq, dk, dv
