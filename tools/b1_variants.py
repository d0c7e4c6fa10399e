#!/usr/bin/env python3
"""Edited copies of kernel B1 (the PCPM gather) against the shipped source,
at the kron-21 cell of ``chip_smoke.py``, on one CUDA card.

    python3 tools/b1_variants.py          # from the root of a checkout

Each variant is ``src/repro_torch/csrc/pcpm_gather.cu`` with a few text
edits (``VARIANTS`` below): ablations that drop one part of a path's
work, so that the time they save is what that part costs ("warp": the
random bins read, the global atomics, both; "tile": the bins read, the
shared-memory atomics, the flush, all three), run through the path they
edit. ``SCHEDULES`` run the shipped "tile" source under other host
parameters of its schedule: no hubs (every add a shared atomic), other
tile sizes, two waves of blocks. All copies are built together by
``repro_torch.kernels._build`` (one nvcc each) into
``src/repro_torch/_build/``, bound as ``kernel.load_library``
binds the shipped library, held against the plain version (inputs that
are multiples of 1/16, so every order of the sums gives the same bits:
the shipped paths must match exactly, an ablation differs by design)
and timed with CUDA events in turns (every entry, then every entry again
in reverse order). ``cuobjdump -sass`` of the shipped library names the
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
# from 25 to 21
SCALE, EDGE_FACTOR, PART_SIZE = 21, 31, 65536
REPS = 20

WARP_BINS = "      float v = valid ? load_value(src + c) : 0.0f;"
WARP_ATOMIC = "      if (valid && tail) atomicAdd(dst + c, v);"
TILE_BINS = "        vs[s] = ok[s] ? load_value(pb + us[s]) : 0.0f;"
TILE_ATOMIC = "    if (!hit) atomicAdd(sacc + jt, v);"
TILE_FLUSH = ("      if (s.x != 0.0f || s.y != 0.0f || s.z != 0.0f || "
              "s.w != 0.0f) {")
# an ablated part keeps its data dependence (a value nobody can prove
# absent), so the compiler cannot drop the loads that feed it
NO_WARP_BINS = (WARP_BINS, "      float v = valid ? 1.0f : 0.0f;")
NO_WARP_ATOMIC = (WARP_ATOMIC,
                  "      if (valid && tail && v == -1.0f) "
                  "atomicAdd(dst + c, v);")
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
    "warp_no_bins": ("warp", [NO_WARP_BINS]),
    "warp_no_atomics": ("warp", [NO_WARP_ATOMIC]),
    "warp_index_only": ("warp", [NO_WARP_BINS, NO_WARP_ATOMIC]),
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
    lib = ctypes.CDLL(str(path))
    lib.pcpm_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.pcpm_gather.restype = ctypes.c_int
    return lib


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


def main() -> None:
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
    paths = write_variants(b1.SOURCE.read_text(),
                           _build.BUILD_DIR / "variants")
    built = dict(zip(paths, _build.build(*paths.values())))
    log(f"built {len(built)} variants in "
        f"{max(b.seconds for b in built.values()):.1f} s")
    for name, b in built.items():
        lines = b.log.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and "tile13gather_kernelIf"
                  in line)
        props = [line.split("info    :")[-1].strip()
                 for line in lines[at + 1:at + 4]
                 if "Used" in line or "spill" in line]
        log(f"ptxas {name} (tile, float32): " + "; ".join(props))
    for kernel, ops_found in atomics_in_sass(built["tile"].path).items():
        log(f"sass {kernel[:70]}: {' '.join(ops_found) or 'no atomics'}")
    libs = {name: bind(b.path) for name, b in built.items()}

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = generators.rmat(SCALE, EDGE_FACTOR, seed=0)
    blocked = block_png(build_png(g, Partitioning(g.num_nodes, PART_SIZE)))
    packed = pack_blocked(blocked, g.num_nodes, device=dev)
    log(f"kron-21 layout on the card in {time.perf_counter() - t0:.1f} s")
    schedules = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, opts in {"tile": {}, **SCHEDULES}.items():
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
    ref = pcpm_gather_ref(bins, packed.edge_upd, packed.edge_dst,
                          part_size=PART_SIZE)

    # entries: variant sources through their path, and the shipped "tile"
    # source under the other schedules
    entries = {name: (name, schedules["tile"] if path == "tile" else None)
               for name, (path, _) in VARIANTS.items()}
    entries.update({name: ("tile", schedules[name]) for name in SCHEDULES})

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

    times = {name: [] for name in entries}
    errors = {}
    for name in list(entries) + list(reversed(entries)):
        lib_name, schedule = entries[name]
        b1._lib = libs[lib_name]

        def call():
            return b1.pcpm_gather_cuda(bins, packed.edge_upd,
                                       packed.edge_dst, part_size=PART_SIZE,
                                       schedule=schedule)
        if name not in errors:
            out = call()
            torch.cuda.synchronize()
            errors[name] = (float((out - ref).abs().max()),
                            bool(torch.equal(out, ref)))
        times[name].append(time_ms(call))
    for name in entries:
        path = "tile" if entries[name][1] is not None else "warp"
        log(f"variant {name} (path {path}): {times[name]!r} ms, max_abs_err "
            f"{errors[name][0]!r}, exact {errors[name][1]} ({card})")
    for name in ("warp", "tile", *SCHEDULES):
        if not errors[name][1]:
            log(f"b1_variants: FAILED: shipped {name} is not the plain "
                "version's output")
            sys.exit(1)


if __name__ == "__main__":
    main()
