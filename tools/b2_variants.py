#!/usr/bin/env python3
"""Kernels B2 and B2-bwd against an earlier version of their source and
against the shipped design's alternatives, on one CUDA card.

    git show <commit>:src/repro_torch/csrc/embedding_bag.cu \\
        > src/repro_torch/_build/embedding_bag_parent.cu
    python3 tools/b2_variants.py [--parent FILE] [--rounds N] [--no-steps]

The earlier source (``--parent``, by default the file above) is built
beside the shipped one by ``repro_torch.kernels._build`` (one nvcc each,
together) and bound as ``kernel.load_library`` binds the shipped one. It
must have the C interface B2 had before its redesign: one
``embedding_bag_fwd`` taking ``kernel.ARGS`` with a block per
``THREADS // group`` bags, and ``embedding_bag_bwd`` taking the 16
arguments of ``Parent.bwd_args``; this script does its host side.

Shapes, each with this run's data made from seeds: MIND's serve_p99 and
serve_bulk lookups (histories of Zipf ids on the 10M x 64 float32
table), MIND's train_batch table gradient (B2-bwd over its 3,342,336
ids), graphcast at ogb_products/32 (B2 gathering the destinations and
the sources, B2 weighted by the edge mask as a segment-sum's gradient
runs it, B2-bwd summing by destination with the mask) and equiformer-v2
at full_graph_sm (B2 gathering, B2-bwd summing its (E, 6272) messages
and its edge softmax's (E, 8) float32 exponentials, as
``gnn._segment_softmax`` calls it). Variants: ``parent``; ``shipped``;
yardsticks the port never calls (``index_select``, ``F.embedding_bag``,
a zeroed tensor's ``index_add_``, and ``zero_`` of an output-sized
tensor: the bytes a gather must write); for B2 the shipped loop with 8
bags in flight a thread (an edited copy of the source, ``EDITS``) and,
at the GNN gathers, the shipped kernel and ``index_select`` with every
id 0 and with the ids taken modulo 4096 (the table's reads from cache:
what the writes cost); for B2-bwd on rows narrower than a slab, blocks
of the fewest warps that hold the block's teams in place of the
shipped ``THREADS`` threads (fewer threads to stage the keys, rows and
weights). Every
variant's output is held to the parent's, bit for bit (the sums keep
their order). Times are CUDA-event means over a call's repetitions,
taken in ``--rounds`` alternating rounds (every variant, then every
variant in reverse order), and compared by their medians; the ratio to
``parent`` is printed per shape, and a shape where ``shipped`` is more
than 5% slower is named at the end.

Then (unless ``--no-steps``) whole training steps of equiformer-v2 at
full_graph_sm and graphcast at ogb_products/32, as ``chip_smoke.py``'s
phase 15 trains them, with the port's B2 and B2-bwd calls sent to the
parent's kernels or the shipped ones in alternating rounds of
``STEPS_PER_ROUND`` steps on one model (the same host code otherwise):
each step's ms from CUDA events, a step's host read included, and the
medians. A JSON summary goes to ``chiprun_out/b2_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

# training steps a variant takes in a round of the step A/B
STEPS_PER_ROUND = 2
# edited copies of the shipped source, built beside it: {name: [(anchor,
# replacement)]}; an anchor that left the source raises
EDITS = {
    "batch8": [("constexpr int kSimtBatch = 4;",
               "constexpr int kSimtBatch = 8;")],
}


def libraries(parent: Path):
    """(the parent's library, {edit name: library}): the parent source
    copied into the build directory, the edited copies written there,
    all built together with the shipped source."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import kernel as k
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    dst = _build.BUILD_DIR / "embedding_bag_parent.cu"
    if parent.resolve() != dst.resolve():
        dst.write_text(parent.read_text())
    shipped = k.SOURCE.read_text()
    edited = {}
    for name, edits in EDITS.items():
        text = shipped
        for anchor, replacement in edits:
            if anchor not in text:
                raise ValueError(f"edit {name}: anchor {anchor!r} not in "
                                 f"{k.SOURCE}")
            text = text.replace(anchor, replacement)
        edited[name] = _build.BUILD_DIR / f"embedding_bag_{name}.cu"
        edited[name].write_text(text)
    built = _build.build(dst, *edited.values(), k.SOURCE)
    lib = ctypes.CDLL(str(built[0].path))
    for fn in (lib.embedding_bag_fwd, lib.embedding_bag_bwd):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, {name: k.bind(ctypes.CDLL(str(b.path)))
                 for name, b in zip(edited, built[1:])}


class Parent:
    """The earlier source's host side: B2 with one block per ``THREADS
    // group`` bags, B2-bwd with one thread group per chunk."""

    def __init__(self, lib):
        from repro_torch.kernels import _launch
        self.lib = lib
        self.bwd_args = _launch.Args(
            "table_bf16", "dout", "keys", "perm", "w", "L", "N", "V", "d",
            "grad", "present", "partials", "chunk", "group", "chunk_blocks",
            "zero_blocks")

    def bag(self, table, idx, weights=None):
        import torch
        from repro_torch.kernels import _launch
        from repro_torch.kernels.embedding_bag import kernel as k
        b, l = idx.shape
        d = table.shape[1]
        out = table.new_empty((b, d))
        _, group, blocks = k.geometry(b, d, table.element_size())
        w = None if weights is None else weights.to(torch.float32)
        args = k.launch_args(table, idx, (b, l), idx.stride(), w, out,
                             group, blocks)
        err = self.lib.embedding_bag_fwd(args, _launch.raw_stream(
            table.device))
        if err:
            raise RuntimeError(f"parent B2: CUDA error {err}")
        return out

    def lookup(self, table, ids):
        return self.bag(table, ids.reshape(-1, 1)).view(*ids.shape,
                                                        table.shape[1])

    def bwd(self, dout, idx, weights, num_rows):
        import torch
        from repro_torch.kernels import _launch
        from repro_torch.kernels.embedding_bag import kernel as k
        d, n, dev = dout.shape[1], idx.numel(), dout.device
        dout = dout.contiguous()
        w = (None if weights is None
             else weights.to(torch.float32).contiguous())
        keys, perm = k.sorted_keys(idx, num_rows)
        n_chunks = -(-n // k.BWD_CHUNK)
        _, group, chunk_blocks = k.geometry(n_chunks, d, dout.element_size())
        zero_blocks = max(1, min(-(-num_rows // (k.THREADS // group)),
                                 k.ZERO_BLOCKS))
        grad = dout.new_empty((num_rows, d))
        present = torch.zeros(num_rows, dtype=torch.uint8, device=dev)
        partials = torch.empty((max(n_chunks, 1), 2, d), dtype=torch.float32,
                               device=dev)
        args = self.bwd_args.pack(
            int(dout.dtype == torch.bfloat16), dout.data_ptr(),
            keys.data_ptr(), perm.data_ptr(), 0 if w is None else
            w.data_ptr(), idx.shape[1], n, num_rows, d, grad.data_ptr(),
            present.data_ptr(), partials.data_ptr(), k.BWD_CHUNK, group,
            chunk_blocks, zero_blocks)
        err = self.lib.embedding_bag_bwd(args, _launch.raw_stream(dev))
        if err:
            raise RuntimeError(f"parent B2-bwd: CUDA error {err}")
        return grad


def patched(obj, **values):
    """A call of ``fn`` with module attributes set for its duration."""
    def wrap(fn):
        def call():
            saved = {name: getattr(obj, name) for name in values}
            for name, value in values.items():
                setattr(obj, name, value)
            try:
                return fn()
            finally:
                for name, value in saved.items():
                    setattr(obj, name, value)
        return call
    return wrap


def fewest_warps(geometry):
    """``kernel.bwd_geometry`` with blocks of the fewest warps that hold
    their teams where a row is narrower than a slab (the same teams and
    chunks a block; the shipped blocks are ``THREADS`` threads)."""
    import dataclasses

    def geo(n_chunks, d, element_size):
        g = geometry(n_chunks, d, element_size)
        return (dataclasses.replace(g, threads=-(-(g.cpb * g.team) // 32)
                                    * 32) if g.slabs == 1 else g)
    return geo


def step_ab(dev, arch, shape_name, parent, rounds, card, results) -> None:
    """Training steps of ``arch`` at ``shape_name`` (phase 15's cell:
    bfloat16 messages, float32 masters, AdamW) with B2 and B2-bwd sent to
    the parent's kernels or the shipped ones, in alternating rounds of
    ``STEPS_PER_ROUND`` steps on one model after a step of each."""
    import dataclasses
    import torch
    from repro_torch import data
    from repro_torch.configs import get
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import gnn
    from repro_torch.optim import AdamW
    from repro_torch.train.trainer import _host_metrics
    shape = cs.gnn_shapes()[shape_name]
    g = data.batch_for_shape(shape, seed=0, device=dev)
    cfg = dataclasses.replace(get(arch), act_dtype="bfloat16")
    n_out = cfg.n_vars or 16
    model = gnn.init_gnn(cfg, shape.d_feat, n_out, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(lr=cs.GNN_TRAIN_LR)
    state = opt.init(model)
    step = gnn.make_gnn_train_step(cfg, opt, n_out=n_out)
    kernels = {"shipped": {}, "parent": {
        "embedding_lookup_cuda": parent.lookup,
        "embedding_bag_cuda": parent.bag,
        "embedding_bag_bwd_cuda": parent.bwd}}
    times = {name: [] for name in kernels}

    def run(name, record):
        nonlocal model, state
        saved = {a: getattr(ops, a) for a in kernels[name]}
        for attr, fn in kernels[name].items():
            setattr(ops, attr, fn)
        try:
            for _ in range(STEPS_PER_ROUND if record else 1):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                model, state, metrics = step(model, state, g)
                end.record()
                _host_metrics(metrics)          # one host read a step
                if record:
                    times[name].append(start.elapsed_time(end))
        finally:
            for attr, fn in saved.items():
                setattr(ops, attr, fn)

    for name in kernels:
        run(name, False)
    order = list(kernels)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else reversed(order)):
            run(name, True)
    med = {name: float(np.median(t)) for name, t in times.items()}
    label = f"{arch} {shape_name} training step"
    cs.log(f"b2 variants {label} ({rounds} alternating rounds of "
           f"{STEPS_PER_ROUND} steps; medians, ratio to parent): "
           + "; ".join(f"{n} {m!r} ms ({m / med['parent']:.3f})"
                       for n, m in med.items()) + f" ({card})")
    cs.log(f"b2 variants {label} steps: {times!r}")
    results[label] = {"median_ms": med, "rounds_ms": times}
    del model, state, step, g
    torch.cuda.empty_cache()


def compare(label, variants, reps, rounds, card, results,
            yardsticks=None) -> None:
    """Check every variant's output against ``parent``'s bit for bit,
    then time them and the ``yardsticks`` (calls the port never makes,
    not held to its bits) in alternating rounds; log medians and ratios
    to ``parent``."""
    import torch
    want = variants["parent"]()
    for name, fn in variants.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            cs.fail(f"b2 variants {label}: {name} differs from parent")
    del want
    variants = {**variants, **(yardsticks or {})}
    times = {name: [] for name in variants}
    order = list(variants)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else reversed(order)):
            times[name].append(cs.time_ms(variants[name], reps=reps))
    med = {name: float(np.median(t)) for name, t in times.items()}
    base = med["parent"]
    cs.log(f"b2 variants {label} ({rounds} alternating rounds of {reps} "
           f"calls; medians, ratio to parent): " + "; ".join(
               f"{n} {m!r} ms ({m / base:.3f})" for n, m in med.items())
           + f" ({card})")
    cs.log(f"b2 variants {label} rounds: {times!r}")
    results[label] = {"median_ms": med, "rounds_ms": times}


def main() -> None:
    import torch
    import torch.nn.functional as F
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=ROOT / "src" /
                        "repro_torch" / "_build" /
                        "embedding_bag_parent.cu")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--no-steps", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script runs on a "
                "CUDA card")
    if not args.parent.is_file():
        cs.fail(f"no earlier B2 source at {args.parent} (write it with "
                "git show <commit>:src/repro_torch/csrc/embedding_bag.cu)")
    from repro_torch import data
    from repro_torch.configs import RECSYS_SHAPES, get
    from repro_torch.kernels.embedding_bag import kernel as k
    dev = torch.device("cuda")
    card = cs.card_line()
    parent_lib, edited = libraries(args.parent)
    parent = Parent(parent_lib)
    k.load_library()
    cs.log(f"card: {card}; parent {args.parent}")
    results, rounds = {}, args.rounds

    def b2_variants(table, ids):
        return {"parent": lambda: parent.lookup(table, ids),
                "shipped": lambda: k.embedding_lookup_cuda(table, ids),
                "8 bags in flight": patched(k, _lib=edited["batch8"])(
                    lambda: k.embedding_lookup_cuda(table, ids))}

    def bwd_variants(dout, idx, w, v):
        out = {"parent": lambda: parent.bwd(dout, idx, w, v),
               "shipped": lambda: k.embedding_bag_bwd_cuda(dout, idx, w, v)}
        geo = k.bwd_geometry(1, dout.shape[1], dout.element_size())
        if geo.slabs == 1 and geo.cpb * geo.team <= k.THREADS - 32:
            out["fewest warps"] = patched(
                k, bwd_geometry=fewest_warps(k.bwd_geometry))(
                lambda: k.embedding_bag_bwd_cuda(dout, idx, w, v))
        return out

    # ------------------------------------------------ MIND
    cfg = get(cs.MIND_ARCH)
    shapes = {s.name: s for s in RECSYS_SHAPES}
    table = torch.randn((cfg.vocab, cfg.embed_dim),
                        generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    rng = np.random.default_rng(0)
    for name, reps in (("serve_p99", 50), ("serve_bulk", 5)):
        hist = torch.from_numpy(cs.histories(
            rng, shapes[name].global_batch, cfg)).to(dev)
        flat = hist.reshape(-1, 1)
        valid = flat < cfg.vocab
        lib_ids, lib_w = torch.where(valid, flat, 0), valid.float()
        out = torch.empty((flat.shape[0], cfg.embed_dim), device=dev)
        compare(f"B2 MIND {name} ({hist.numel()} ids)",
                b2_variants(table, hist), reps, rounds, card, results,
                {"F.embedding_bag": lambda: F.embedding_bag(
                    lib_ids, table, mode="sum", per_sample_weights=lib_w),
                 "write floor (zero_ of the output)": out.zero_})
        del hist, flat, valid, lib_ids, lib_w, out
    b = shapes["train_batch"].global_batch
    ids = np.concatenate([cs.histories(rng, b, cfg).reshape(-1),
                          cs.zipf_ids(rng, (b,), cfg.vocab)])
    idx = torch.from_numpy(ids).to(dev).view(-1, 1)
    dout = torch.randn((idx.shape[0], cfg.embed_dim), device=dev) / b
    keep = idx[:, 0] < cfg.vocab
    keys, rows = idx[keep, 0].long(), dout[keep]
    compare(f"B2-bwd MIND train_batch ({idx.shape[0]} ids)",
            bwd_variants(dout, idx, None, cfg.vocab), 5, rounds, card,
            results, {"zeros + index_add_": lambda: torch.zeros(
                (cfg.vocab, cfg.embed_dim), device=dev).index_add_(
                    0, keys, rows)})
    del keep, keys, rows
    del table, idx, dout
    torch.cuda.empty_cache()

    # ------------------------------------------------ the GNNs
    gshapes = cs.gnn_shapes()
    for arch, name in (("graphcast", f"ogb_products/{cs.GNN_OGB_CUT}"),
                       ("equiformer-v2", "full_graph_sm")):
        g = data.batch_for_shape(gshapes[name], seed=0, device=dev)
        d = cs.message_width(get(arch))
        n, e = g.num_nodes, g.edge_dst.numel()
        gen = torch.Generator(device=dev).manual_seed(16)
        table = torch.randn((n, d), generator=gen, device=dev).bfloat16()
        values = torch.randn((e, d), generator=gen, device=dev).bfloat16()
        reps = 20 if e * d < 10 ** 8 else 5
        label = f"{arch} {name} (E {e}, N {n}, d {d} bf16)"
        out = torch.empty((e, d), device=dev, dtype=torch.bfloat16)
        for end in ("dst", "src") if arch == "graphcast" else ("dst",):
            ids = getattr(g, f"edge_{end}")
            long_ids = ids.long()
            row0 = torch.zeros_like(long_ids)
            near = ids % 4096          # rows of a table slice L2 holds
            near_long = near.long()
            compare(f"B2 gather edge_{end}, {label}",
                    b2_variants(table, ids), reps, rounds, card, results,
                    {"index_select": lambda: table.index_select(0, long_ids),
                     "write floor (zero_ of the output)": out.zero_,
                     "shipped, every id 0": lambda: k.embedding_lookup_cuda(
                         table, row0),
                     "index_select, every id 0": lambda: table.index_select(
                         0, row0),
                     "shipped, ids mod 4096": lambda: k.embedding_lookup_cuda(
                         table, near),
                     "index_select, ids mod 4096": lambda: table.index_select(
                         0, near_long)})
        del out
        if arch == "graphcast":
            mask = (torch.randint(0, 3, (e, 1), generator=gen, device=dev)
                    / 2.0)
            bags = g.edge_dst[:, None]
            compare(f"B2 weighted, {label}",
                    {"parent": lambda: parent.bag(table, bags, mask),
                     "shipped": lambda: k.embedding_bag_cuda(table, bags,
                                                             mask)},
                    reps, rounds, card, results)
        ones = torch.ones((e, 1), device=dev)
        dst = g.edge_dst.long()
        compare(f"B2-bwd segment-sum, {label}",
                bwd_variants(values, g.edge_dst[:, None], ones, n), reps,
                rounds, card, results,
                {"zeros + index_add_": lambda: torch.zeros(
                    (n, d), dtype=torch.bfloat16, device=dev).index_add_(
                        0, dst, values)})
        if arch == "equiformer-v2":
            # the edge softmax's denominators: segment_sum of (E, heads)
            # float32 exponentials, no weights
            nh = get(arch).n_heads
            expo = torch.rand((e, nh), generator=gen, device=dev)
            compare(f"B2-bwd softmax segment-sum, {arch} {name} (E {e}, "
                    f"N {n}, d {nh} f32)",
                    bwd_variants(expo, g.edge_dst[:, None], None, n), reps,
                    rounds, card, results,
                    {"zeros + index_add_": lambda: torch.zeros(
                        (n, nh), device=dev).index_add_(0, dst, expo)})
            del expo
        del g, table, values
        torch.cuda.empty_cache()

    if not args.no_steps:
        for arch, name in (("equiformer-v2", "full_graph_sm"),
                           ("graphcast", f"ogb_products/{cs.GNN_OGB_CUT}")):
            step_ab(dev, arch, name, parent, rounds, card, results)

    slower = [label for label, r in results.items()
              if r["median_ms"]["shipped"] > 1.05 * r["median_ms"]["parent"]]
    cs.log(f"b2 variants: shapes where shipped is more than 5% slower than "
           f"parent: {slower} ({card})")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b2_variants.json").write_text(json.dumps(
        {"card": card, "results": results}, indent=1))


if __name__ == "__main__":
    main()
