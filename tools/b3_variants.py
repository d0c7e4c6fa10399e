#!/usr/bin/env python3
"""Edited copies of kernel B3's "tc" path against the shipped source, on
one CUDA card.

    python3 tools/b3_variants.py          # from the root of a checkout

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` with a few
text edits (``VARIANTS`` below): ablations that drop one part of the
tile loop, so that the time they save is what that part costs, and
alternatives to the shipped design. All are built together by
``repro_torch.kernels._build`` (one nvcc each) into
``src/repro_torch/_build/``, bound as ``kernel.load_library`` binds the
shipped library, held against the plain version at each shape (the
LM's gate, rtol 1.6e-2 and atol 2e-3: an ablation fails it by design)
and timed with CUDA events in turns (every variant, then every variant
again in reverse order). The "clock" copy also counts clock64() cycles
per phase of the loop, summed over the first thread of every
warpgroup, at D 64.

The edits are anchored on exact lines of the shipped source; a variant
whose anchor is gone raises, so the list follows the source.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (B, S, Hq, Hkv, D), causal, bfloat16: the LM's prefill, and D 128
SHAPES = {"prefill d64": (4, 2048, 32, 4, 64),
          "d128": (1, 2048, 16, 2, 128)}
GATE = dict(rtol=1.6e-2, atol=2e-3)
REPS = 20

PV_BOTH = ("          wgmma_rs_n64(o[a], pa[kk], dv);\n"
           "          wgmma_rs_n64(o[a], pb[kk], dv);")
GRID = ("  const int hb = blockIdx.x % heads, rb = blockIdx.x / heads;\n"
        "  const int b = hb / p.Hkv, kvh = hb % p.Hkv;\n"
        "  const int n_rb = (int)((rows + kRows - 1) / kRows);\n"
        "  const int row0 = (n_rb - 1 - rb) * kRows;")
LOOP_HEAD = ("  for (int t = t_begin; t < t_end; ++t) {\n"
             "    const int i = t - t_begin;\n")
SYNC = ("    __syncthreads();                    "
        "// ... for every thread; tile t - 1 done\n")
SKIP = ("    if (t < wt_begin || t >= wt_end) continue;   "
        "// warpgroup-uniform\n")
S_WAIT = "    wgmma_commit();\n    wgmma_wait0();\n    fence_regs(s);\n"
PV_HEAD = "    // O += P V:"
LOOP_END = ("    for (int a = 0; a < C::kAtoms; ++a) fence_regs(o[a]);\n  }\n"
            "  // nothing left in flight")
PHASES = ("wait + barrier", "K/V copies", "S wgmma", "softmax", "P V wgmma")

VARIANTS = {
    "shipped": [],
    # P in bfloat16 alone (no low part): the cost of the split, and the
    # accuracy it buys
    "p_bf16_only": [(PV_BOTH, "          wgmma_rs_n64(o[a], pa[kk], dv);")],
    "no_exp": [("      s[j] = fast_exp2(fmaf(s[j], scale_log2, -m_use[h]));",
                "      s[j] = fmaf(s[j], scale_log2, -m_use[h]);")],
    "no_s_wgmma": [("      wgmma_ss_n64(s, da, db);",
                    "      (void)da;\n      (void)db;")],
    "no_pv_wgmma": [(PV_BOTH, "          (void)dv;")],
    "no_kv_loads": [("    if (t + C::kStages - 1 < t_end)\n      load_kv(",
                     "    if (false)\n      load_kv(")],
    # one warpgroup a block (64 rows), 2 stages, 4 blocks an SM
    "one_warpgroup": [
        ("constexpr int kWGs = 2;", "constexpr int kWGs = 1;"),
        ("  static constexpr int kStages = D == 128 ? 2 : 3;",
         "  static constexpr int kStages = 2;"),
        ("__launch_bounds__(kThreads, D == 128 ? 1 : 2)",
         "__launch_bounds__(kThreads, D == 128 ? 2 : 4)")],
    # the grid order before the linear heaviest-first one: row blocks
    # lightest first within each (b, kv head)
    "light_first_per_head": [(GRID, (
        "  const int n_rb = (int)((rows + kRows - 1) / kRows);\n"
        "  const int hb = blockIdx.x / n_rb, rb = blockIdx.x % n_rb;\n"
        "  const int b = hb / p.Hkv, kvh = hb % p.Hkv;\n"
        "  const int row0 = rb * kRows;"))],
    "clock": [
        ("namespace {\n\nconstexpr unsigned kFull",
         "__device__ unsigned long long g_clock[7];\n\n"
         "namespace {\n\nconstexpr unsigned kFull"),
        (LOOP_HEAD, "  long long c_sum[6] = {0, 0, 0, 0, 0, 0};\n" + LOOP_HEAD
         + "    const long long c0 = clock64();\n"),
        (SYNC, SYNC + "    const long long c1 = clock64();\n"),
        (SKIP, SKIP + "    const long long c2 = clock64();\n"),
        (S_WAIT, S_WAIT + "    const long long c3 = clock64();\n"),
        (PV_HEAD, "    const long long c4 = clock64();\n" + PV_HEAD),
        (LOOP_END, (
            "    for (int a = 0; a < C::kAtoms; ++a) fence_regs(o[a]);\n"
            "    const long long c5 = clock64();\n"
            "    c_sum[0] += c1 - c0;\n    c_sum[1] += c2 - c1;\n"
            "    c_sum[2] += c3 - c2;\n    c_sum[3] += c4 - c3;\n"
            "    c_sum[4] += c5 - c4;\n    c_sum[5] += 1;\n  }\n"
            "  if (wtid == 0 && D == 64) {\n"
            "    for (int u = 0; u < 6; ++u)\n"
            "      atomicAdd(&g_clock[u], (unsigned long long)c_sum[u]);\n"
            "    atomicAdd(&g_clock[6], 1ull);\n  }\n"
            "  // nothing left in flight")),
        ('extern "C" {\n', 'extern "C" {\n'
         "int clock_read(unsigned long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock));\n"
         "}\nint clock_reset() {\n"
         "  unsigned long long z[7] = {0, 0, 0, 0, 0, 0, 0};\n"
         "  return (int)cudaMemcpyToSymbol(g_clock, z, sizeof(z));\n}\n")],
}


def log(msg: str) -> None:
    print(msg, flush=True)


def write_variants(source: str, out_dir: Path) -> dict[str, Path]:
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: anchor not found once "
                                   f"in the source: {old[:60]!r}")
            text = text.replace(old, new)
        paths[name] = out_dir / f"b3_{name}.cu"
        paths[name].write_text(text)
    return paths


def bind(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with ``kernel.load_library``'s argtypes."""
    from repro_torch.kernels.flash_attention import kernel as b3
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_fwd.argtypes = b3.FWD_ARGTYPES
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def tc_registers(log_text: str) -> dict[str, str]:
    """'registers, spill stores' of each tc_fwd_kernel<D> (the inference
    instance, without the training epilogue) in a ptxas log: the lines
    after its 'Function properties for' line."""
    out, lines = {}, log_text.splitlines()
    for i, line in enumerate(lines):
        if ("Function properties for" in line and "tc_fwd_kernel" in line
                and "Lb1E" not in line):    # the inference instances
            d = line.split("tc_fwd_kernelILi")[1].split("E")[0]
            rest = lines[i + 1:i + 4]
            spill = next(x.split("bytes stack frame, ")[1].split(",")[0]
                         for x in rest if "bytes stack frame, " in x)
            regs = next(x.split("Used ")[1].split(",")[0]
                        for x in rest if "Used " in x)
            out[f"D{d}"] = f"{regs}, {spill}"
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        log("b3_variants: torch.cuda.is_available() is False: this script "
            "runs on a CUDA card")
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import kernel as b3

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    paths = write_variants(b3.SOURCE.read_text(),
                           _build.BUILD_DIR / "variants")
    built = dict(zip(paths, _build.build(*paths.values())))
    log(f"built {len(built)} variants in "
        f"{max(b.seconds for b in built.values()):.1f} s")
    libs = {name: bind(b.path) for name, b in built.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for key, (b, s, hq, hkv, d) in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((b, s, hq, d), (b, s, hkv, d),
                                 (b, s, hkv, d)))
        cases[key] = (q, k, v, attention_ref(q.float(), k.float(), v.float(),
                                             causal=True))

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    times = {name: {key: [] for key in cases} for name in libs}
    errors = {}
    for name in list(libs) + list(reversed(libs)):
        b3._lib = libs[name]
        for key, (q, k, v, ref) in cases.items():
            def call():
                return b3.flash_attention_cuda(q, k, v, causal=True)
            if name not in errors or key not in errors[name]:
                out = call().float()
                torch.cuda.synchronize()
                err = (out - ref).abs()
                ratio = float((err / (GATE["atol"] + GATE["rtol"]
                                      * ref.abs())).max())
                errors.setdefault(name, {})[key] = (float(err.max()), ratio)
            times[name][key].append(time_ms(call))
    for name in libs:
        regs = tc_registers(built[name].log)
        log(f"variant {name}: " + "; ".join(
            f"{key} {times[name][key]!r} ms, max_abs_err "
            f"{errors[name][key][0]!r} (err/allowed "
            f"{errors[name][key][1]:.3f})" for key in cases)
            + f"; registers, spill stores {regs} ({card})")

    lib = libs["clock"]
    lib.clock_reset.restype = lib.clock_read.restype = ctypes.c_int
    b3._lib = lib
    q, k, v, _ = cases["prefill d64"]
    lib.clock_reset()
    b3.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * 7)()
    lib.clock_read(counts)
    tiles = counts[5]
    log(f"clock at prefill d64: {tiles} warpgroup-tiles over {counts[6]} "
        "warpgroups; cycles per warpgroup-tile: " + ", ".join(
            f"{phase} {counts[u] / tiles:.0f}"
            for u, phase in enumerate(PHASES)) + f" ({card})")


if __name__ == "__main__":
    main()
