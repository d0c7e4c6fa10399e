#!/usr/bin/env python3
"""Kernel B3-bwd's "tc" path against edited copies and earlier versions,
on one CUDA card.

    python3 tools/b3_bwd_variants.py [--other PATH ...]   # from a checkout

Variants: ``shipped`` (``src/repro_torch/csrc/flash_attention_bwd.cu``);
``dq_bf16``, the same source with dS in bfloat16 alone in the dQ kernel's
product (one wgmma a step instead of two: what the two-part split costs
and what it buys); ablations that drop one part of the dK/dV loop
(``dkv_no_exp``, ``dkv_no_loads``: wrong by design), alternatives
(``no_tma``, ``stages_plus1``) and ``clock``, a copy that counts
clock64() cycles per phase of the dK/dV loop at D 64 (these five only
measure); and with ``--other`` (repeatable), any other B3-bwd
source with the same C interface (``BWD_ARGS``), named by its file's
stem, e.g. an earlier version from ``git show`` (before the "tc" path,
bfloat16 calls ran on the float32 cores). All are built together
by ``repro_torch.kernels._build`` (one nvcc each), bound as
``kernel.load_bwd_library`` binds the shipped one, held against the
plain version at tinyllama's and mixtral's training shapes (the
bfloat16 gate of ``chip_smoke.py`` phase 13) and timed with CUDA events
in turns (every variant, then every variant again in reverse order).
Then each of the others gives the whole gradient of tinyllama-1.1b
(random bfloat16 weights from seed 0) on a (1, 2048) batch, against the
plain attention backward's: the worst relative L2 error of a parameter,
the gate of phase 13 (c).

The edits are anchored on exact lines of the shipped source; a variant
whose anchor is gone raises, so the list follows the source.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

VARIANTS = {
    "shipped": [],
    "dq_bf16": [
        ("        split_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1], "
         "hi[kk][e],\n                   lo[kk][e]);",
         "        hi[kk][e] = pack_bf16(dp[8 * kk + 2 * e], "
         "dp[8 * kk + 2 * e + 1]);"),
        ("        wgmma_rs(dq[a], hi[kk], dk);\n"
         "        wgmma_rs(dq[a], lo[kk], dk);",
         "        wgmma_rs(dq[a], hi[kk], dk);")],
    # the dK/dV kernel without its exponentials (wrong by design): what
    # the exp unit costs there
    "dkv_no_exp": [
        ("        s[4 * c + e] = fast_exp2(fmaf(s[4 * c + e], scale_log2,\n"
         "                                      -((e & 1) ? l2.y : l2.x) * "
         "kLog2e));",
         "        s[4 * c + e] = fmaf(s[4 * c + e], scale_log2,\n"
         "                            -((e & 1) ? l2.y : l2.x) * kLog2e);")],
    # the dK/dV ring by cp.async, and without its copies after the first
    # stages (wrong by design): what issuing 16-byte copies costs (no TMA:
    # a stage no copy fills would never complete its barrier)
    "dkv_no_loads": [
        ("  constexpr int NQ = C::kQRows;\n",
         "  constexpr int NQ = C::kQRows;\n  tma = false;\n"),
        ("    if (it + C::kStages - 1 < items)\n      load_item(",
         "    if (false)\n      load_item(")],
    # the rings by per-thread 16-byte cp.async copies instead of TMA
    "no_tma": [
        ("  constexpr int NQ = C::kQRows;\n",
         "  constexpr int NQ = C::kQRows;\n  tma = false;\n"),
        ("  const uint32_t sKV = sdO + C::kRowBytes;   // stage st: K, then V\n",
         "  const uint32_t sKV = sdO + C::kRowBytes;   // stage st: K, then V\n"
         "  tma = false;\n")],
    # one more stage in both kernels' rings
    "stages_plus1": [
        ("  static constexpr int kStages = D == 128 ? 2 : 3;",
         "  static constexpr int kStages = D == 128 ? 3 : 4;")],
    # clock64() counts per phase of the dK/dV kernel's item loop, summed
    # over the first thread of every warpgroup, at D 64
    "clock": [
        ("namespace {\n\nconstexpr int kThreads = 128;",
         "__device__ unsigned long long g_clock[8];\n\n"
         "namespace {\n\nconstexpr int kThreads = 128;"),
        ("  for (int it = 0; it < items; ++it) {\n"
         "    cp_async_wait<C::kStages - 2>();   // item it (and K, V) landed\n"
         "    if (tma) mbar_wait(sBar + 8 * (it % C::kStages), "
         "(it / C::kStages) & 1);\n"
         "    fence_async_smem();\n"
         "    __syncthreads();                    // ... for every thread; "
         "item it - 1 done\n",
         "  long long c_sum[7] = {0, 0, 0, 0, 0, 0, 0};\n"
         "  for (int it = 0; it < items; ++it) {\n"
         "    const long long c0 = clock64();\n"
         "    cp_async_wait<C::kStages - 2>();   // item it (and K, V) landed\n"
         "    if (tma) mbar_wait(sBar + 8 * (it % C::kStages), "
         "(it / C::kStages) & 1);\n"
         "    fence_async_smem();\n"
         "    const long long c0a = clock64();\n"
         "    __syncthreads();                    // ... for every thread; "
         "item it - 1 done\n"
         "    const long long c0b = clock64();\n"),
        ("    if (t < wt_begin || t >= wt_end) continue;   "
         "// warpgroup-uniform\n\n    const int stage = it % C::kStages;\n",
         "    if (t < wt_begin || t >= wt_end) continue;   "
         "// warpgroup-uniform\n    const long long c1 = clock64();\n"
         "\n    const int stage = it % C::kStages;\n"),
        ("    wgmma_commit();\n    wgmma_wait0();\n    fence_regs(s);\n"
         "    fence_regs(dp);\n\n    // P^T, then",
         "    wgmma_commit();\n    wgmma_wait0();\n    fence_regs(s);\n"
         "    fence_regs(dp);\n    const long long c2 = clock64();\n\n"
         "    // P^T, then"),
        ("    // dV += P^T dO, dK += dS^T Q:",
         "    const long long c3 = clock64();\n"
         "    // dV += P^T dO, dK += dS^T Q:"),
        ("      fence_regs(dv[a]);\n    }\n  }\n  cp_async_wait<0>();\n",
         "      fence_regs(dv[a]);\n    }\n"
         "    const long long c4 = clock64();\n"
         "    c_sum[0] += c0a - c0;\n    c_sum[1] += c0b - c0a;\n"
         "    c_sum[2] += c1 - c0b;\n    c_sum[3] += c2 - c1;\n"
         "    c_sum[4] += c3 - c2;\n    c_sum[5] += c4 - c3;\n"
         "    c_sum[6] += 1;\n  }\n"
         "  if (wtid == 0 && D == 64) {\n"
         "    for (int u = 0; u < 7; ++u)\n"
         "      atomicAdd(&g_clock[u], (unsigned long long)c_sum[u]);\n"
         "    atomicAdd(&g_clock[7], 1ull);\n  }\n"
         "  cp_async_wait<0>();\n"),
        ('extern "C" {\n', 'extern "C" {\n'
         "int clock_read(unsigned long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock));\n"
         "}\nint clock_reset() {\n"
         "  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
         "  return (int)cudaMemcpyToSymbol(g_clock, z, sizeof(z));\n}\n")],
}
# variants that only measure: no whole-model gradient
MEASURE_ONLY = ("dkv_no_exp", "dkv_no_loads", "no_tma", "stages_plus1",
                "clock")
PHASES = ("copies' wait", "barrier", "copies' issue", "S and dP products",
          "P and dS", "dV and dK products")
GRAD_SHAPE = (1, 2048)


def write_variants(source: str, out_dir: Path,
                   others: list[Path]) -> dict[str, Path]:
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: anchor not found once "
                                   f"in the source: {old[:60]!r}")
            text = text.replace(old, new)
        paths[name] = out_dir / f"b3_bwd_{name}.cu"
        paths[name].write_text(text)
    for other in others:
        paths[other.stem] = out_dir / f"b3_bwd_{other.stem}.cu"
        paths[other.stem].write_text(other.read_text())
    return paths


def bind(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with ``kernel.load_bwd_library``'s
    argtypes."""
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_bwd.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                        ctypes.c_void_p]
    lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


def main() -> None:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", type=Path, action="append", default=[],
                        help="another B3-bwd source with the same C "
                             "interface, timed beside the shipped one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script runs on a "
                "CUDA card")
    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.kernels.flash_attention import ops as b3_ops
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card}")
    paths = write_variants(b3.BWD_SOURCE.read_text(),
                           _build.BUILD_DIR / "bwd_variants", args.other)
    built = dict(zip(paths, _build.build(b3.SOURCE, *paths.values())[1:]))
    for name, b in built.items():
        cs.log(f"build {name}: {b.seconds:.1f} s; " + "; ".join(
            f"{kernel} {props}" for kernel, props in cs.ptxas_report(b.log)
            if "dkv" in kernel or "dq" in kernel))
    libs = {name: bind(b.path) for name, b in built.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    tiny, mix = get(cs.ARCH), get(cs.MOE_ARCH)
    cases = {
        "tinyllama (4, 4096)": (
            cs.b3_bwd_inputs(dev, gen, 4, tiny.n_heads, tiny.n_kv_heads,
                             4096, tiny.dh, torch.bfloat16),
            dict(causal=True)),
        "mixtral (1, 4096)": (
            cs.b3_bwd_inputs(dev, gen, 1, mix.n_heads, mix.n_kv_heads,
                             4096, mix.dh, torch.bfloat16),
            dict(causal=True, window=mix.window))}
    refs = {}
    for key, ((q, k, v, do), kw) in cases.items():
        _, lse, o32 = flash_attention_cuda(q, k, v, for_backward=True, **kw)
        rows = [attention_bwd_ref(*(x[i:i + 1].float() for x in (q, k, v, do)),
                                  **kw) for i in range(q.shape[0])]
        refs[key] = (lse, o32, [torch.cat(g) for g in zip(*rows)])
        del rows
        torch.cuda.empty_cache()

    times = {name: {key: [] for key in cases} for name in libs}
    ratios = {name: {} for name in libs}
    for name in list(libs) + list(reversed(libs)):
        b3._bwd_lib = libs[name]
        for key, ((q, k, v, do), kw) in cases.items():
            lse, o32, want = refs[key]

            def call():
                return flash_attention_bwd_cuda(q, k, v, o32, lse, do, **kw)
            if key not in ratios[name]:
                got = call()
                # a non-finite gradient reads as inf, never as a pass
                ratios[name][key] = max(
                    float(((g.float() - w).abs() / (
                        cs.B3_BWD_BF16_TOL * w.abs()
                        + cs.B3_BWD_BF16_TOL * w.abs().max())).nan_to_num(
                            nan=float("inf")).max())
                    for g, w in zip(got, want))
                del got
            times[name][key].append(cs.time_ms(call, reps=5, warmup=1))
    if "clock" in libs:
        lib = libs["clock"]
        lib.clock_reset.restype = lib.clock_read.restype = ctypes.c_int
        b3._bwd_lib = lib
        (q, k, v, do), kw = cases["tinyllama (4, 4096)"]
        lse, o32, _ = refs["tinyllama (4, 4096)"]
        lib.clock_reset()
        flash_attention_bwd_cuda(q, k, v, o32, lse, do, **kw)
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * 8)()
        lib.clock_read(counts)
        items = counts[6]
        cs.log(f"clock, dK/dV kernel at tinyllama (4, 4096): {items} "
               f"warpgroup-items over {counts[7]} warpgroups; cycles per "
               "warpgroup-item: " + ", ".join(
                   f"{phase} {counts[u] / items:.0f}"
                   for u, phase in enumerate(PHASES)) + f" ({card})")
    for name in libs:
        cs.log(f"B3-bwd {name}: " + "; ".join(
            f"{key} {times[name][key]!r} ms (err/allowed "
            f"{ratios[name][key]:.3f})" for key in cases) + f" ({card})")
    del cases, refs
    torch.cuda.empty_cache()

    model = tf.init_lm(tiny, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, tiny.vocab, (GRAD_SHAPE[0], GRAD_SHAPE[1] + 1))).to(dev)
    real = b3_ops.flash_attention_bwd_cuda

    def plain_bwd(q, k, v, o, lse, do, **kw):
        return attention_bwd_ref(q, k, v, do, **kw)
    b3_ops.flash_attention_bwd_cuda = plain_bwd
    try:
        _, plain = cs.param_grads(model, toks[:, :-1], toks[:, 1:])
    finally:
        b3_ops.flash_attention_bwd_cuda = real
    for name, lib in libs.items():
        if name in MEASURE_ONLY:
            continue
        b3._bwd_lib = lib
        _, grads = cs.param_grads(model, toks[:, :-1], toks[:, 1:])
        rel = {n: float((g.float() - plain[n].float()).norm()
                        / plain[n].float().norm().clamp_min(1e-30))
               for n, g in grads.items()}
        worst = max(rel, key=rel.get)
        wq = max(v for n, v in rel.items() if n.endswith("wq"))
        cs.log(f"whole-model gradient with {name}, {tiny.name} {GRAD_SHAPE}: "
               f"worst relative L2 {rel[worst]!r} ({worst}); worst of the "
               f"wq leaves {wq!r} (gate {cs.GRAD_REL_L2})")
        del grads
    b3._bwd_lib = None


if __name__ == "__main__":
    main()
