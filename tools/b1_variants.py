#!/usr/bin/env python3
"""Edited copies of kernel B1 (the PCPM gather) against the shipped source,
at the kron-21 cell of ``chip_smoke.py``, on one CUDA card.

    python3 tools/b1_variants.py          # from the root of a checkout
    python3 tools/b1_variants.py --paths warp --sass warp.sass

Each variant is ``src/repro_torch/csrc/pcpm_gather.cu`` with a few text
edits (``VARIANTS`` below): ablations that drop one part of a path's
work, so that the time they save is what that part costs ("warp": the
random row read, the run flushes' vector atomics, both, the
``update_src`` read, the walk over the keys; "tile": the bins read, the
shared-memory atomics, the flush, all three), and the "tile" loop
alternatives, run through the path they edit: "tile" at d = 1 over its
gather order, "warp" at the serving stepper's d = 16 in its fused form
(rows of x read through ``update_src``, as ``pcpm_spmv_pallas`` calls
it; the shipped source from bins too). ``SCHEDULES`` run the shipped
"tile" source under other host parameters of its schedule (no hubs,
other tile sizes, two waves of blocks), ``GEOMETRIES`` the shipped
"warp" source under other launch geometries (longer ranges, so that a
round spans several partitions; fewer blocks); the "warp" ablations run
under the shipped source's geometry. All copies are built
together by ``repro_torch.kernels._build`` (one nvcc each) into
``src/repro_torch/_build/``, bound as ``kernel.load_library`` binds the
shipped library, held against the plain version (inputs that are
multiples of 1/16, so every order of the sums gives the same bits: the
shipped paths must match exactly, an ablation differs by design) and
timed with CUDA events in turns (every entry, then every entry again in
reverse order). ``cuobjdump -sass`` of the shipped library names the
atomic instructions each kernel compiled to.

The edits are anchored on exact lines of the shipped source; a variant
whose anchor is gone raises, so the list follows the source.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py's kron-21 cell: configs/pagerank_kron.py with the scale cut
# from 25 to 21; the serving stepper's 16 slots
SCALE, EDGE_FACTOR, PART_SIZE, SERVE_D = 21, 31, 65536, 16
REPS = 20

WARP_ROWS = ("                       ? S::load(rows + (long long)rq * sh.d + "
             "col)")
WARP_FLUSH = "  if constexpr (W % 4 == 0) {\n#pragma unroll\n    for (int q = 0; q < W; q += 4) {"
TILE_BINS = "        vs[s] = ok[s] ? load_value(pb + us[s]) : 0.0f;"
TILE_ATOMIC = "    if (!hit) atomicAdd(sacc + jt, v);"
TILE_FLUSH = ("      if (s.x != 0.0f || s.y != 0.0f || s.z != 0.0f || "
              "s.w != 0.0f) {")
# an ablated part keeps its data dependence (a value nobody can prove
# absent), so the compiler cannot drop the loads that feed it: without the
# row read a slice is zero, without the flush a run's sum is still compared
NO_WARP_ROWS = (WARP_ROWS, "                       ? S::zero()")
NO_WARP_ATOMIC = (WARP_FLUSH, "  if (sum[0] != -1.0f) return;\n" + WARP_FLUSH)
# the fused form without its update_src read: row u of x (as valid a row,
# but the rows of every partition are then the same 382,660 rows)
WARP_USRC = "          r = ok ? __ldg(update_src + r) : 0;"
NO_WARP_USRC = (WARP_USRC, "          r = ok ? u[c] : 0;")
# keys and rows computed (index loads, update_src reads), the walk over
# them (shuffles, row loads, runs, flushes) skipped: a condition nobody
# can prove false keeps the keys live
WARP_WALK = ("#pragma unroll 1\n"
             "        for (int t0 = 0; t0 < kFetch; t0 += kChunk) {")
KEYS_ONLY = (WARP_WALK, WARP_WALK.replace(
    "t0 < kFetch;", "t0 < (key[0] + key[1] + key[2] + key[3] + row[0] "
    "+ row[1] + row[2] + row[3] == -7 ? kFetch : 0);"))
NO_TILE_BINS = (TILE_BINS, "        vs[s] = ok[s] ? 1.0f : 0.0f;")
NO_TILE_ATOMIC = (TILE_ATOMIC,
                  "    if (!hit && v == -1.0f) atomicAdd(sacc + jt, v);")
NO_TILE_FLUSH = (TILE_FLUSH, "      if (s.x == -1.0f) {")
UNROLL = "constexpr int kUnroll = 1;"
# the index loads of a step issued at its start (no prefetch)
NO_PREFETCH = [("    fetch(a0 / 4 + threadIdx.x);\n", ""),
               ("      fetch(i + kUnroll * kThreads);\n", ""),
               ("      int us[kEdges], js[kEdges];\n",
                "      int us[kEdges], js[kEdges];\n      fetch(i);\n")]

# name -> (path, edits)
VARIANTS = {
    "warp": ("warp", []),
    "warp_no_rows": ("warp", [NO_WARP_ROWS]),
    "warp_no_atomics": ("warp", [NO_WARP_ATOMIC]),
    "warp_index_only": ("warp", [NO_WARP_ROWS, NO_WARP_ATOMIC]),
    "warp_no_update_src": ("warp", [NO_WARP_USRC]),
    "warp_keys_only": ("warp", [KEYS_ONLY]),
    "warp_keys_only_no_update_src": ("warp", [KEYS_ONLY, NO_WARP_USRC]),
    "tile": ("tile", []),
    "tile_no_bins": ("tile", [NO_TILE_BINS]),
    "tile_no_smem_atomics": ("tile", [NO_TILE_ATOMIC]),
    "tile_no_flush": ("tile", [NO_TILE_FLUSH]),
    "tile_index_only": ("tile", [NO_TILE_BINS, NO_TILE_ATOMIC,
                                 NO_TILE_FLUSH]),
    # alternatives: two int4 pairs a thread per step, and the index loads
    # of a step issued at its start, with one pair and with two
    "tile_unroll2": ("tile", [(UNROLL, "constexpr int kUnroll = 2;")]),
    "tile_no_prefetch": ("tile", NO_PREFETCH),
    "tile_no_prefetch_unroll2": ("tile", [
        (UNROLL, "constexpr int kUnroll = 2;"), *NO_PREFETCH]),
}
# the shipped "tile" source under other host parameters of its schedule:
# tile_bytes (default ops.TILE_BYTES), waves of blocks (default one: the
# blocks whose shared memory fits the card at once), and hubs (default on:
# without, every add goes through the shared atomics)
SCHEDULES = {
    "tile without hubs": dict(hubs=False),
    "tile 48 KB tiles": dict(tile_bytes=48 * 1024),
    "tile 128 KB tiles": dict(tile_bytes=128 * 1024),
    "tile 2 waves": dict(waves=2),
}
# the shipped "warp" source (fused form) under other launch geometries:
# ranges 4x and 16x the shipped one (a round then spans about 4 and 16
# partitions, so their rows no longer fit L2 together), and half and a
# quarter of the blocks of one wave (the shipped range scaled up to keep
# one partition a round)
GEOMETRIES = {
    "warp range x2": dict(range_scale=2),
    "warp range x4": dict(range_scale=4),
    "warp range x16": dict(range_scale=16),
    "warp blocks /2": dict(block_div=2),
}
# ablations run under the shipped source's geometry, so that a variant
# that needs fewer registers is not also given more blocks
ABLATIONS = ("warp_no_rows", "warp_no_atomics", "warp_index_only",
             "warp_no_update_src", "warp_keys_only",
             "warp_keys_only_no_update_src")


def log(msg: str) -> None:
    print(msg, flush=True)


def write_variants(source: str, out_dir: Path) -> dict[str, Path]:
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (_, edits) in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: anchor not found once "
                                   f"in the source: {old[:60]!r}")
            text = text.replace(old, new)
        paths[name] = out_dir / f"b1_{name}.cu"
        paths[name].write_text(text)
    return paths


def bind(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with ``kernel.load_library``'s argtypes."""
    from repro_torch.kernels.pcpm_spmv import kernel
    return kernel.bind(ctypes.CDLL(str(path)))


def scaled_geometry(real, range_scale=1, block_div=1):
    """``kernel.warp_geometry`` with its range and blocks changed."""
    def geometry(d, bf16, aligned, part_slots, blocks_of):
        g = real(d, bf16, aligned, part_slots,
                 lambda v, n: max(1, blocks_of(v, n) // block_div))
        return dataclasses.replace(g, range=g.range * range_scale)
    return geometry


def atomics_in_sass(path: Path) -> dict[str, list[str]]:
    """The atomic and reduction opcodes (ATOM*, RED*) of each kernel in
    the library, from ``cuobjdump -sass``."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
    out = subprocess.run([str(cuobjdump / "cuobjdump"), "-sass", str(path)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    found, kernel = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
            found[kernel] = []
        elif kernel and ("ATOM" in line or " RED" in line):
            op = line.split("*/")[1].strip().split()[0] if "*/" in line else ""
            if op and op not in found[kernel]:
                found[kernel].append(op)
    return found


def sass_of(path: Path, kernel: str) -> str:
    """``cuobjdump -sass`` of the kernels in the library whose mangled
    name contains ``kernel``."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
    out = subprocess.run([str(cuobjdump / "cuobjdump"), "-sass", str(path)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    keep, text = False, []
    for line in out.splitlines():
        if "Function :" in line:
            keep = kernel in line
        if keep:
            text.append(line)
    return "\n".join(text) + "\n"


def main() -> None:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--paths", default="warp,tile",
                        help="comma-separated paths whose variants run "
                             "(default: warp,tile)")
    parser.add_argument("--sass", type=Path, default=None,
                        help="write the SASS of the shipped 'warp' kernel "
                             "(float32, 16-byte slices, 4 lanes) "
                             "to this file")
    opts = parser.parse_args()
    paths_run = set(opts.paths.split(","))
    import torch
    if not torch.cuda.is_available():
        log("b1_variants: torch.cuda.is_available() is False: this script "
            "runs on a CUDA card")
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Partitioning, block_png, build_png
    from repro_torch.graphs import generators
    from repro_torch.kernels import _build
    from repro_torch.kernels.pcpm_spmv import kernel as b1
    from repro_torch.kernels.pcpm_spmv import (ops, pack_blocked,
                                               pcpm_gather_ref,
                                               tile_schedule)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    paths = {name: path for name, path in write_variants(
        b1.SOURCE.read_text(), _build.BUILD_DIR / "variants").items()
        if VARIANTS[name][0] in paths_run or name == "warp"}
    built = dict(zip(paths, _build.build(*paths.values())))
    log(f"built {len(built)} variants in "
        f"{max(b.seconds for b in built.values()):.1f} s")
    # the kernels each path runs here: "tile" float32, "warp" float32 at
    # 16-byte slices, 4 lanes an edge
    mangled = {"tile": "tile13gather_kernelIf",
               "warp": "warp13gather_kernelIfLi4ELi4EE"}
    for name, b in built.items():
        lines = b.log.splitlines()
        path = VARIANTS[name][0]
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and mangled[path] in line)
        props = [line.split("info    :")[-1].strip()
                 for line in lines[at + 1:at + 4]
                 if "Used" in line or "spill" in line]
        log(f"ptxas {name} ({path}, float32): " + "; ".join(props))
    for name in ("warp", "tile"):
        if name in built:
            for kernel, found in atomics_in_sass(built[name].path).items():
                log(f"sass {kernel[:90]}: {' '.join(found) or 'no atomics'}")
    if opts.sass is not None:
        opts.sass.parent.mkdir(parents=True, exist_ok=True)
        opts.sass.write_text(sass_of(built["warp"].path, mangled["warp"]))
        log(f"SASS of the shipped warp kernel written to {opts.sass}")
    libs = {name: bind(b.path) for name, b in built.items()}

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = generators.rmat(SCALE, EDGE_FACTOR, seed=0)
    blocked = block_png(build_png(g, Partitioning(g.num_nodes, PART_SIZE)))
    packed = pack_blocked(blocked, g.num_nodes, device=dev)
    log(f"kron-21 layout on the card in {time.perf_counter() - t0:.1f} s")
    schedules = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile_schedules = {"tile": {}, **SCHEDULES} if "tile" in paths_run else {}
    for name, opts in tile_schedules.items():
        tile_bytes = opts.get("tile_bytes", ops.TILE_BYTES)
        t0 = time.perf_counter()
        s = tile_schedule(blocked, tile_bytes=tile_bytes,
                          blocks=opts.get("waves", 1) * ops.tile_blocks(
                              dev, tile_bytes), device=dev)
        if not opts.get("hubs", True):
            s = dataclasses.replace(s, hubs=torch.full_like(s.hubs, -1))
        schedules[name] = s
        log(f"schedule {name}: tile {s.tile}, {s.chunks.shape[0]} chunks "
            f"over {s.blocks} blocks ({sms} SMs), {s.nbytes} B on the "
            f"card, built in {time.perf_counter() - t0:.1f} s")
    log(f"packed streams: "
        f"{2 * packed.edge_upd.numel() * 4} B on the card")

    k, u = packed.update_src.shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 16, (g.num_nodes, 1), generator=gen,
                      device=dev).float() / 16
    bins = x[packed.update_src.view(-1)].view(k, u, 1)
    x16 = torch.randint(0, 16, (g.num_nodes, SERVE_D), generator=gen,
                        device=dev).float() / 16
    bins16 = x16[packed.update_src.view(-1)].view(k, u, SERVE_D)
    refs = {"tile": pcpm_gather_ref(bins, packed.edge_upd, packed.edge_dst,
                                    part_size=PART_SIZE),
            "warp": pcpm_gather_ref(bins16, packed.edge_upd,
                                    packed.edge_dst, part_size=PART_SIZE)}

    def tile_call(schedule):
        return lambda: b1.pcpm_gather_cuda(
            bins, packed.edge_upd, packed.edge_dst, part_size=PART_SIZE,
            schedule=schedule)

    def fused_call():
        return b1.pcpm_spmv_cuda(x16, packed.update_src, packed.edge_upd,
                                 packed.edge_dst, part_size=PART_SIZE)

    def bins_call():
        return b1.pcpm_gather_cuda(bins16, packed.edge_upd,
                                   packed.edge_dst, part_size=PART_SIZE)

    # entries: name -> (library, path, call, geometry options): variant
    # sources through their path ("warp" in the fused form), the shipped
    # "warp" from bins, the shipped "tile" under the other schedules and
    # the shipped "warp" under the other geometries
    entries = {name: (name, path, tile_call(schedules["tile"])
                      if path == "tile" else fused_call, {})
               for name, (path, _) in VARIANTS.items()
               if path in paths_run}
    if "warp" in paths_run:
        entries["warp from bins"] = ("warp", "warp", bins_call, {})
        entries.update({name: ("warp", "warp", fused_call, opts)
                        for name, opts in GEOMETRIES.items()})
    entries.update({name: ("tile", "tile", tile_call(schedules[name]), {})
                    for name in SCHEDULES if name in schedules})

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

    real_geometry = b1.warp_geometry
    b1._lib = libs["warp"]
    shipped = real_geometry(SERVE_D, False, True, packed.edge_upd[0].numel(),
                            lambda vec, lanes: b1._wave_blocks(
                                dev, False, vec, lanes))
    times = {name: [] for name in entries}
    errors, geometries = {}, {}
    try:
        for name in list(entries) + list(reversed(entries)):
            lib_name, path, call, opts = entries[name]
            b1._lib = libs[lib_name]
            b1._wave_blocks.cache_clear()     # occupancy of this library
            b1.warp_geometry = scaled_geometry(real_geometry, **opts)
            if name in ABLATIONS:
                b1.warp_geometry = lambda *a: shipped
            if name not in errors:
                out = call()
                torch.cuda.synchronize()
                errors[name] = (float((out - refs[path]).abs().max()),
                                bool(torch.equal(out, refs[path])))
                if path == "warp":
                    geometries[name] = b1.warp_geometry(
                        SERVE_D, False, True, packed.edge_upd[0].numel(),
                        lambda vec, lanes: b1._wave_blocks(
                            dev, False, vec, lanes))
            times[name].append(time_ms(call))
    finally:
        b1.warp_geometry = real_geometry
    for name, (_, path, _, _) in entries.items():
        at = (f" d={SERVE_D}, {geometries[name]}" if path == "warp"
              else " d=1")
        log(f"variant {name} (path {path},{at}): {times[name]!r} ms, "
            f"max_abs_err {errors[name][0]!r}, exact {errors[name][1]} "
            f"({card})")
    for name in ("warp", "warp from bins", "tile", *SCHEDULES, *GEOMETRIES):
        if name in errors and not errors[name][1]:
            log(f"b1_variants: FAILED: shipped {name} is not the plain "
                "version's output")
            sys.exit(1)


if __name__ == "__main__":
    main()
