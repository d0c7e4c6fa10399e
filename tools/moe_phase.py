#!/usr/bin/env python3
"""Phases 8 and 10b of ``chip_smoke.py`` alone, on one CUDA card: kernel
B3 against its plain version at every shape of phase 8 (phase 10b's
included), then the MoE and sliding-window LMs (mixtral-8x7b, grok-1-314b
and deepseek-67b at their published widths with their depth cut).

    python3 tools/moe_phase.py      # from the root of a checkout

Prints the phases' lines and B3's entries of the kernels line at phase
10b's shapes. Exits non-zero where a gate fails.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from repro_torch.kernels.flash_attention import load_library
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card} (torch {torch.__version__}, CUDA "
           f"{torch.version.cuda})")
    load_library()
    dev = torch.device("cuda")
    entries = cs.moe_phases(dev, card, cs.check_b3_shapes(dev))
    print(json.dumps({"kernels": entries}), flush=True)


if __name__ == "__main__":
    main()
