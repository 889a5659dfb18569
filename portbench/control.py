#!/usr/bin/env python3
"""The control of ``correct``: the plain reference computed in float32, the
precision below the configurations' float64, put in the program's place
and judged by the same comparisons as a run.  A sound check reads it as
not correct.

    python3 portbench/control.py --workload s7-batched --seeds 1 2 3

prints, a line a seed, the numbers compared against their limits, at the
cell's own size.  It imports nothing of the program.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import check, gen, reference  # noqa: E402


def readings(config: dict, traffic: dict, seed: int) -> dict[str, float]:
    """The numbers a run compares, with the control in the program's
    place, for the inputs of ``seed``."""
    plan, online = reference.policy(config["policy"])
    numbers: dict[str, float] = {}
    for i in range(int(traffic.get("inputs", 1))):
        inst = gen.instance(config, traffic, seed, i)
        sides = [reference.Cluster.make(inst.capacities, config["cluster"], F)
                 for F in (np.float64, np.float32)]
        horizon, u = int(config["horizon"]), float(config["u"])
        if traffic["kind"] == "backlog":
            runs = []
            for cl in sides:
                s = plan(cl, inst.jobs, horizon, u)
                runs.append((s, reference.simulate(cl, inst.jobs,
                                                   s.assignment)))
            check.merge(numbers, check.schedule_numbers(
                runs[1], runs[0], len(inst.jobs)))
            continue
        runs, outcomes = [], []
        for cl in sides:
            s, out = online(cl, inst.jobs, inst.arrivals, horizon, u)
            runs.append((s, reference.simulate(cl, inst.jobs, s.assignment,
                                               inst.arrivals)))
            outcomes.append(out)
        check.merge(numbers, check.schedule_numbers(runs[1], runs[0],
                                                    len(inst.jobs)))
        differing = 0
        for j, want in outcomes[0].items():
            got = outcomes[1].get(j)
            if (got is None) != (want is None):
                differing += 1
            elif got is not None:
                differing += not (np.array_equal(got[0], want[0])
                                  and float(got[1]) == float(want[1])
                                  and float(got[2]) == float(want[2]))
        check.merge(numbers, {"decisions_differing": differing})
    return numbers


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    from portbench import harness
    _, config, traffic = harness.cell(harness.manifest(), args.workload)
    for seed in args.seeds:
        numbers = readings(config, traffic, seed)
        correct, _ = check.verdict(numbers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": correct, "numbers": numbers}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
