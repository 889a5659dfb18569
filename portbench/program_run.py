#!/usr/bin/env python3
"""A cell's run with the program's recorder on over its window.

``harness.run`` does not start the program's recorder.  Until it does
(three lines in its traced path: :func:`program.start` before the
window, :func:`program.stop` after it, the intervals to
``devtrace.read``), :func:`run` here gets the same from outside:
``kernels.reset_launch_counts``, the harness's last call before the
window, also starts the recorder; ``devtrace.read``, its first call
after a traced window, also stops it and takes the program's spans; and
the harness's record is caught on its way to the readers.  A traced run
also puts a second wrapper of the benchmark's kind
(``drive.wrap_entry_points``) around each kernel entry point: what it
adds to the first is the first's own cost a call, in place, which
``program.summary`` takes off before it compares the first's seconds
with the program's spans.  From the root of a checkout::

    python3 portbench/program_run.py --workload s7-batched --seed 12345 \\
        --seconds 51 --trace 1

prints the cell's result line with the numbers of ``program.METRICS``
and, traced, a ``program`` part (``program.summary``).  ``--trace 0``
runs the untraced window with the recorder on, which is what recording
costs (its ``setup_s`` leaves out the imports that run.py's counts).
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

if __name__ == "__main__":
    # As run.py: one host thread for the numeric libraries, set before
    # any of them loads.
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_var] = "1"
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]


def run(workload: dict, config: dict, traffic: dict, seed: int,
        seconds: float, trace: bool, metrics: list[dict],
        device="cuda") -> dict:
    """``harness.run`` with the program's recorder on over its window.
    Adds to the result the ``program.METRICS`` of the cell's kind (those
    with a number) and, traced, ``program.summary`` as ``program``."""
    from portbench import devtrace, drive, harness, program
    from repro_torch import kernels

    got: dict = {}
    outer = drive.Probe()
    reset, read, reader = (kernels.reset_launch_counts, devtrace.read,
                           harness.reader)
    wrap = drive.wrap_entry_points

    def wrap_twice(probe, spans):
        undo_inner = wrap(probe, spans)
        undo_outer = wrap(outer, drive.Spans(True))

        def undo():
            undo_outer()
            undo_inner()
        return undo

    def reset_and_start():
        reset()
        program.start()

    def stop_and_read(prof, t0, t1, spans, kernel_names):
        got["program"] = program.stop()
        got["bench_spans"] = [s for s in spans if s[1] >= t0 and s[2] <= t1]
        mine = got["program"]["intervals"] if got["program"] else []
        return read(prof, t0, t1, list(spans) + mine, kernel_names)

    def capture(name):
        if name != "_record":
            return reader(name)
        return lambda rec: got.setdefault("rec", rec) and None

    kernels.reset_launch_counts = reset_and_start
    devtrace.read = stop_and_read
    harness.reader = capture
    drive.wrap_entry_points = wrap_twice
    try:
        result = harness.run(workload, config, traffic, seed, seconds, trace,
                             list(metrics) + [{"name": "_record",
                                               "unit": "-"}],
                             device=device)
    finally:
        kernels.reset_launch_counts, devtrace.read = reset, read
        harness.reader, drive.wrap_entry_points = reader, wrap
    if not trace:         # nothing of the program runs after the window
        got["program"] = program.stop()
    rec = dict(got["rec"], program=got["program"])
    suffix = ".sched" if rec["kind"] == "backlog" else ".service"
    for base, fn in program.METRICS.items():
        value = fn(rec)
        if value is not None:
            result["metrics"][base + suffix] = {"value": float(value)}
    if trace and rec["program"] is not None:
        calls = rec["program"]["calls"]
        own = {name: 1e6 * (outer.spent[name] - spent)
               / calls[f"kernel.{name}"]
               for name, spent in rec["entry_s"].items() if spent}
        result["program"] = program.summary(
            rec, got["bench_spans"],
            result.get("breakdown", {}).get("idle_gaps", []), own)
    return result


def main() -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch

    from portbench import harness
    torch.set_num_threads(1)
    man = harness.manifest()
    workload, config, traffic = harness.cell(man, args.workload)
    result = run(workload, config, traffic, args.seed, args.seconds,
                 bool(args.trace),
                 harness.metrics_for(man, args.workload, bool(args.trace)))
    for line in result.pop("lines"):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
