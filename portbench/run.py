#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

From the root of a checkout, on a machine with an NVIDIA card::

    python3 portbench/run.py --workload s7-batched --seed 12345 \
        --seconds 30 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; ``--seed`` makes its inputs.  After a warm pass (set-up) the
window drives the program for at least ``--seconds`` seconds of whole
units of work; then the reference checks every output of the window.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a run traced by torch.profiler.  The comparisons
and their limits go last to standard error; the result is the last line
of standard output, one JSON object.  Exits non-zero, printing no result,
without a CUDA card, without the program beside ``BENCHMARK.json``, or if
the run loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One host thread for the numeric libraries, set before any of them loads:
# the scheduler's host arrays are small, and a pool of threads on a shared
# host only adds to the spread between runs.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    from portbench import harness
    man = harness.manifest()
    workload, config, traffic = harness.cell(man, args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(workload["chips"]):
        print(f"portbench: the cell needs {workload['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the program (src/repro_torch) is missing: {exc}",
              file=sys.stderr)
        return 2
    try:
        result = harness.run(workload, config, traffic, args.seed,
                             args.seconds, bool(args.trace),
                             harness.metrics_for(man, args.workload,
                                                 bool(args.trace)),
                             device="cuda", t_start=T_START)
    except ImportError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    lines = result.pop("lines")
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
