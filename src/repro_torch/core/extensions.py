"""Beyond-paper scheduler extensions (recorded separately from the
faithful SJF-BCO in benchmarks/ablations).

1. ``sjf-bco-adaptive`` — per-job *adaptive* subroutine choice: instead of
   the paper's hard kappa threshold between FA-FFP (pack) and LBSGF
   (spread), evaluate BOTH placements with the refined rho_hat(y^k)
   estimate and commit whichever finishes earlier.  This removes kappa
   from the inner loop entirely (the bisection on theta_u remains), at 2x
   the placement cost per job — still O(n_g |J| N log N log T).

2. ``contention_sweep`` — sensitivity analysis: scale the contention
   coefficient xi1 (and degradation slope alpha) and measure how the
   SJF-BCO advantage over contention-oblivious baselines changes.  The
   paper's thesis predicts the gap widens with contention.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.api import (PlacementState, ScheduleRequest, ScheduleResult,
                            bisect_theta, finalize, get_policy, nominal_rho,
                            pick_best_finish, register_policy,
                            resolve_placement, schedule_arrivals)
from repro_torch.core.jobs import Job
from repro_torch.core.simulator import simulate
from repro_torch.core.sjf_bco import fa_ffp, lbsgf, sjf_bco_chooser

__all__ = ["sjf_bco_adaptive_policy", "contention_sweep"]


@register_policy("sjf-bco-adaptive")
def sjf_bco_adaptive_policy(request: ScheduleRequest) -> ScheduleResult:
    """Bisection on theta_u with the adaptive pack-or-spread choice; with
    arrivals, the same choice runs in the online epoch loop (identical to
    SJF-BCO online, which is already adaptive).

    The ``placement`` param is validated for interface consistency, but
    the adaptive choice compares two refined scores per job
    (:func:`pick_best_finish`) rather than advancing one picker's pool,
    so both values run the scalar walk -- columnar == scalar trivially
    here."""
    cluster, u = request.cluster, request.u
    engine = request.params.get("engine")
    resolve_placement(request.params)

    if not request.is_batch:
        # Online, the adaptive choice IS SJF-BCO's epoch rule: one shared
        # chooser factory (registered in sjf_bco) serves both names.
        return schedule_arrivals(
            request, sjf_bco_chooser(cluster, u, request.params), "SJF-BCO+")

    rho_noms = {j.jid: nominal_rho(cluster, j) for j in request.jobs}

    def choose(state: PlacementState, job: Job, theta: float) -> bool:
        return pick_best_finish(state, job, [fa_ffp, lbsgf],
                                rho_noms[job.jid], u, theta)

    jobs_sorted = sorted(request.jobs, key=lambda j: (j.num_gpus, j.jid))

    def attempt(theta: float) -> ScheduleResult | None:
        state = PlacementState(cluster, engine=engine)
        for job in jobs_sorted:
            if not choose(state, job, theta):
                return None
        return finalize(state, len(request.jobs), theta, None, "SJF-BCO+")

    return bisect_theta(attempt, request.horizon, "SJF-BCO+")


def contention_sweep(seed: int = 1, xi1s=(0.2, 0.5, 0.7, 1.0),
                     horizon: int = 2400) -> list[dict]:
    """SJF-BCO vs LS (the strongest baseline) as contention intensifies."""
    from repro_torch.core.cluster import philly_cluster
    from repro_torch.core.jobs import philly_workload

    base = philly_cluster(20, seed=seed)
    jobs = philly_workload(seed=seed)
    rows = []
    for xi1 in xi1s:
        cluster = dataclasses.replace(base, xi1=xi1)
        request = ScheduleRequest(cluster=cluster, jobs=jobs, horizon=horizon)
        r = {"xi1": xi1}
        for name, policy in (("sjf", "sjf-bco"), ("sjf+", "sjf-bco-adaptive"),
                             ("ls", "ls")):
            sched = get_policy(policy)(request)
            sim = simulate(cluster, jobs, sched.assignment)
            r[f"{name}_makespan"] = sim.makespan
        r["advantage_vs_ls"] = r["ls_makespan"] / r["sjf_makespan"]
        rows.append(r)
    return rows
