#!/usr/bin/env python3
"""Copies, kernels and host time of one ``pick_orders`` / ``score_probes``
/ ``tau_stack`` call on one NVIDIA card, for any checkout of the port.

Run on a machine with a CUDA card and nvcc::

    python3 chip_probes/placement_calls.py [--src PATH]

``--src`` names the ``src`` directory whose ``repro_torch`` is measured
(default: this checkout's), so one call can hold two trees side by side;
its kernels are built into that tree's ``build/``.  It runs
``chip_smoke.entry_point_copies`` without its gate: one profiled call of
each entry point at the scale point's cluster (HtoD and DtoH copies and
kernels, the host milliseconds split into the CUDA runtime's calls and
the rest) and the mean wall ms per call over 200 calls.  The first line
names the card and its power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("placement_calls: needs a CUDA card")
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke

    import repro_torch
    import repro_torch.core as rt
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"placement_calls: {repro_torch.__file__}; card: {smi}",
          flush=True)
    _build.build()
    chip_smoke.entry_point_copies(torch, np, rt,
                                  repro_torch.resolve_device("cuda"),
                                  gate=False)


if __name__ == "__main__":
    main()
