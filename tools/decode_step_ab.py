#!/usr/bin/env python3
"""Phase 9's decode step of ``chip_smoke.py`` timed under several source
trees on one CUDA card, each run in a process of its own, in the order
given: TinyLlama-1.1B at its configured widths (random bfloat16 weights,
``torch.Generator`` seed 0) in a ``ServeEngine`` of 8 slots at max_len
1024, every slot active after a 512-token prompt, as phase 10 times it
(here with room for every step of the run, so no slot empties).

    python3 tools/decode_step_ab.py OLD . . OLD   # each the root of a tree

For each run: ms per step by CUDA events and the process's CPU ms per
step (32 steps after 2 of warm-up, five rounds; the step is host-bound,
and the CPU time moves less than the wall time when the host's cores
are shared), and the device operations per step (kernels, copies, sets)
and the device's busy share from a profile of 16 steps. The trees may differ in anything but
``ServeEngine``'s and ``init_lm``'s signatures.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SLOTS, MAX_LEN, PROMPT, NEW_TOKENS = 8, 1024, 512, 500
REPS, WARMUP, ROUNDS, PROFILE_STEPS = 32, 2, 5, 16


def child(root: Path) -> dict:
    """Time one tree's decode step; returns its numbers."""
    sys.path[:0] = [str(root / "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import load_library
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServeEngine
    load_library()
    dev = torch.device("cuda")
    cfg = get("tinyllama-1.1b")
    model = tf.init_lm(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
    eng = ServeEngine(cfg, model, batch_slots=SLOTS, max_len=MAX_LEN,
                      sample=lambda logits: logits.argmax(-1))
    for i in range(SLOTS):
        eng.add_request(Request(uid=i, prompt=[1 + i] * PROMPT,
                                max_new_tokens=NEW_TOKENS))
    rounds, cpu = [], []
    for _ in range(ROUNDS):
        for _ in range(WARMUP):
            eng.step()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        c0 = time.process_time()
        start.record()
        for _ in range(REPS):
            eng.step()
        end.record()
        torch.cuda.synchronize()
        cpu.append((time.process_time() - c0) * 1e3 / REPS)
        rounds.append(start.elapsed_time(end) / REPS)
    if eng.active != SLOTS:
        sys.exit(f"{root}: {eng.active} of {SLOTS} slots active")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    kernels = sum(e.count for e in events)
    return {"tree": str(root), "package": repro_torch.__file__,
            "ms_per_step_rounds": rounds,
            "ms_per_step_median": statistics.median(rounds),
            "cpu_ms_per_step_rounds": cpu,
            "cpu_ms_per_step_median": statistics.median(cpu),
            "device_ops_per_step": kernels / PROFILE_STEPS,
            "device_busy_share": busy_us / wall_us if busy_us else None}


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve())), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False")
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card} (torch {torch.__version__})", flush=True)
    runs = []
    for tree in sys.argv[1:]:
        out = subprocess.run([sys.executable, __file__, "--child", tree],
                             capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"{tree}: exit {out.returncode}\n{out.stderr[-4000:]}")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(f"{tree}: {run['ms_per_step_median']!r} ms per decode step "
              f"(median of rounds {run['ms_per_step_rounds']}), CPU "
              f"{run['cpu_ms_per_step_median']!r} ms per step (median of "
              f"{run['cpu_ms_per_step_rounds']}), "
              f"{run['device_ops_per_step']!r} device ops per step, device "
              f"busy {run['device_busy_share']!r} of the wall ({card})",
              flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
