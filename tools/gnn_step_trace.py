#!/usr/bin/env python3
"""Which operators of a GNN training step take the card's time: one
step of graphcast (published widths, bfloat16 messages) at ogb_products
divided by ``--cut`` under ``torch.profiler`` with shapes recorded,
after two warm-up steps.

    python3 tools/gnn_step_trace.py [--cut 32] [--arch graphcast]
                                    [--shape ogb_products] [--top 25]

Prints the operators with the most device time, grouped by input shape
(self device time, calls, shapes), then every ``aten::copy_`` and
``aten::add`` with an input of the step's edge count among its shapes.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="graphcast")
    parser.add_argument("--shape", default="ogb_products")
    parser.add_argument("--cut", type=int, default=cs.GNN_OGB_CUT)
    parser.add_argument("--top", type=int, default=25)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from repro_torch import data
    from repro_torch.configs import GNN_SHAPES, get
    from repro_torch.models import gnn
    from repro_torch.optim import AdamW
    card = cs.card_line()
    dev = torch.device("cuda")
    base = {s.name: s for s in GNN_SHAPES}[args.shape]
    shape = dataclasses.replace(base, n_nodes=base.n_nodes // args.cut,
                                n_edges=base.n_edges // args.cut)
    cfg = dataclasses.replace(get(args.arch), act_dtype="bfloat16")
    n_out = cfg.n_vars or 16
    g = data.batch_for_shape(shape, seed=0, device=dev)
    model = gnn.init_gnn(cfg, shape.d_feat, n_out, device=dev)
    opt = AdamW(lr=cs.GNN_TRAIN_LR)
    state = opt.init(model)
    step = gnn.make_gnn_train_step(cfg, opt, n_out=n_out)
    for _ in range(2):
        step(model, state, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(model, state, g)
        torch.cuda.synchronize()
    events = prof.key_averages(group_by_input_shape=True)
    busy = sum(e.self_device_time_total for e in events
               if e.key.startswith("aten::"))
    cs.log(f"trace {args.arch} at {args.shape}/{args.cut} (N "
           f"{shape.n_nodes}, E {shape.n_edges}), one step: aten "
           f"operators' self device time {busy:.0f} us ({card})")
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)
    for e in ops[:args.top]:
        cs.log(f"  {e.self_device_time_total:10.0f} us x{e.count:<4} "
               f"{e.key} {str(e.input_shapes)[:160]}")
    cs.log(f"copy_ and add with {shape.n_edges} rows among their inputs:")
    for e in ops:
        if (e.key in ("aten::copy_", "aten::add", "aten::add_")
                and str(shape.n_edges) in str(e.input_shapes)):
            cs.log(f"  {e.self_device_time_total:10.0f} us x{e.count:<4} "
                   f"{e.key} {str(e.input_shapes)[:160]}")


if __name__ == "__main__":
    main()
