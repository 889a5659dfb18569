"""Whether what the timed path produced is correct: every schedule, every
simulation and every decision of the window against the plain reference
(:mod:`portbench.reference`), and every acknowledged decision against the
journal read back after the window.

Each number compared has the limit 0: the configurations state float64
results equal bit for bit (``PERF.md`` gives the readings behind it).
"""
from __future__ import annotations

import numpy as np

#: name -> what it counts; every limit is 0.
LIMITS = {
    "jobs_differing": 0,       # jobs placed elsewhere, at another time
    "theta_kappa_gap": 0,      # |theta - ref| + (kappa != ref), backlogs
    "busy_gap": 0,             # |max busy time - ref| (slots)
    "makespan_gap": 0,         # |est. makespan - ref| + |sim. makespan - ref|
    "jct_gap": 0,              # |mean JCT - ref| (slots)
    "sim_jobs_differing": 0,   # jobs whose simulated start or finish differ
    "decisions_differing": 0,  # journaled outcomes unlike the reference's
    "journal_missing": 0,      # acknowledged decisions not in the journal
    "undecided": 0,            # submitted jobs never acknowledged
}


def _placements(assignment) -> dict[int, tuple[int, tuple]]:
    return {int(j): (pos, tuple(int(g) for g in np.asarray(gpus)))
            for pos, (j, gpus) in enumerate(assignment)}


def schedule_numbers(got, want, n: int) -> dict[str, float]:
    """How far one schedule and its simulation lie from the reference's:
    ``got``/``want`` are ``(schedule, sim)`` pairs."""
    (s, m), (rs, rm) = got, want
    a, b = _placements(s.assignment), _placements(rs.assignment)
    start = np.asarray(s.est_start, dtype=np.float64)
    finish = np.asarray(s.est_finish, dtype=np.float64)
    r_start = np.asarray(rs.est_start, dtype=np.float64)
    r_finish = np.asarray(rs.est_finish, dtype=np.float64)
    differing = sum(
        1 for j in range(n)
        if a.get(j) != b.get(j) or j >= len(start) or start[j] != r_start[j]
        or finish[j] != r_finish[j])
    sim_diff = sum(
        1 for j in range(n)
        if j >= len(m.start) or int(m.start[j]) != int(rm.start[j])
        or int(m.finish[j]) != int(rm.finish[j]))
    theta = abs(float(s.theta) - float(rs.theta))
    if rs.kappa is not None or s.kappa is not None:
        theta += float(s.kappa != rs.kappa)
    return {
        "jobs_differing": differing,
        "theta_kappa_gap": theta,
        "busy_gap": abs(float(s.max_busy_time) - float(rs.max_busy_time)),
        "makespan_gap": abs(float(s.est_makespan) - float(rs.est_makespan))
        + abs(float(m.makespan) - float(rm.makespan)),
        "jct_gap": abs(float(m.avg_jct) - float(rm.avg_jct)),
        "sim_jobs_differing": sim_diff,
    }


def decision_numbers(unit, outcomes: dict) -> dict[str, float]:
    """Each decision the daemon acknowledged against its journal, read back
    after the window, and the reference's outcome for that job."""
    rows = [(e.kind, int(e.jid), e.payload) for e in unit["entries"]]
    decided = {jid for kind, jid, _ in rows if kind == "decided"}
    outcome = {}
    for kind, jid, payload in rows:
        if kind == "transition" and payload.get("to") in ("RUNNING",
                                                          "FAILED"):
            outcome[jid] = payload
    acked = [jid for jid, _, _ in unit["store"].decided]
    missing = sum(1 for j in acked if j not in decided or j not in outcome)
    differing = 0
    for j in acked:
        got, want = outcome.get(j), outcomes.get(j)
        if got is None:
            continue
        if want is None:
            differing += got.get("to") != "FAILED"
            continue
        gpus, rho, start = want
        differing += not (got.get("to") == "RUNNING"
                          and list(got["gpus"]) == [int(g) for g in gpus]
                          and float(got["rho"]) == float(rho)
                          and float(got["start"]) == float(start))
    return {"decisions_differing": differing, "journal_missing": missing,
            "undecided": unit["n_jobs"] - len(set(acked))}


def merge(into: dict[str, float], numbers: dict[str, float]) -> None:
    """Keep the worst reading of each number."""
    for k, v in numbers.items():
        v = float("inf") if v != v else v      # NaN reads as the worst
        into[k] = max(into.get(k, 0), v)


def verdict(numbers: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers read."""
    checks = {k: {"value": v, "limit": LIMITS[k]}
              for k, v in numbers.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
