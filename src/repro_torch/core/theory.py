"""Theory checks for SJF-BCO (paper §6), the port's copy of the
reference's certificate (host NumPy; bit-identical fields).

  * Lemma 2 -- max busy time of the returned schedule equals theta_tilde.
  * Lemma 3 -- makespan <= n_g * W_max (busy + gang-idle bound).
  * Theorem 5 -- makespan <= n_g * phi * (u/l) * T_opt; here we compute the
    certified *upper bound* and empirical l, u from simulated actuals.
  * Theorem 6 -- running time O(n_g |J| N log N log T) (asserted-by-design;
    we expose the trial counter for the test).

Callers report the certified ratio alongside the measured makespan;
``chip_smoke.py`` prints it for the §7 run on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.api import ScheduleResult, rho_hat
from repro_torch.core.cluster import Cluster
from repro_torch.core.jobs import Job
from repro_torch.core.simulator import SimResult


@dataclasses.dataclass(frozen=True)
class TheoryReport:
    n_g: int
    theta_tilde: float        # tightest budget found (== max busy time, Lem. 2)
    makespan: float           # actual, from the simulator
    makespan_bound: float     # n_g * W_max (Lemma 3, w.r.t. busy-time clocks)
    l: float                  # empirical lower bracket of rho_hat / rho
    u: float                  # empirical upper bracket of rho_hat / rho
    varphi: float             # max_j rho ratio across schedules (Lemma 4)
    approx_ratio_bound: float  # n_g * varphi * u / l (Theorem 5)
    lower_bound_makespan: float  # max GPU busy time: no schedule can beat this

    @property
    def certified(self) -> bool:
        """Does the end-to-end Thm.-5 chain hold on this instance?"""
        return self.makespan <= self.approx_ratio_bound * max(
            self.lower_bound_makespan, 1e-12)


def empirical_brackets(cluster: Cluster, jobs: list[Job], sim: SimResult
                       ) -> tuple[float, float]:
    """Empirical l, u with rho_hat in [l*rho, u*rho] over completed jobs."""
    ls, us = [], []
    for j in jobs:
        if sim.finish[j.jid] < 0 or sim.start[j.jid] < 0:
            continue
        actual = float(sim.finish[j.jid] - sim.start[j.jid])
        if actual <= 0:
            continue
        ratio = rho_hat(cluster, j) / actual
        ls.append(min(ratio, 1.0))
        us.append(max(ratio, 1.0))
    if not ls:
        return 1.0, 1.0
    return float(min(ls)), float(max(us))


def report(cluster: Cluster, jobs: list[Job], schedule: ScheduleResult,
           sim: SimResult, varphi: float | None = None) -> TheoryReport:
    n_g = max(j.num_gpus for j in jobs)
    l, u = empirical_brackets(cluster, jobs, sim)
    if varphi is None:
        # Worst-case actual-time ratio of one job across candidate schedules;
        # bounded by tau_hi/tau_lo which we take as the conservative default.
        from repro_torch.core.contention import tau_bounds
        ratios = []
        for j in jobs:
            lo, hi = tau_bounds(cluster, j)
            ratios.append(hi / max(lo, 1e-12))
        varphi = float(max(ratios))
    # A makespan lower bound for *any* schedule: total work on the busiest
    # possible GPU cannot be smaller than total_gpu_work / N, and no job can
    # finish faster than its contention-free execution time.
    from repro_torch.core.api import nominal_rho
    total_work = sum(nominal_rho(cluster, j) * j.num_gpus for j in jobs)
    lb = max(total_work / cluster.num_gpus,
             max(nominal_rho(cluster, j) for j in jobs))
    return TheoryReport(
        n_g=n_g,
        theta_tilde=schedule.theta,
        makespan=sim.makespan,
        makespan_bound=n_g * schedule.max_busy_time,
        l=l, u=u, varphi=varphi,
        approx_ratio_bound=n_g * varphi * u / max(l, 1e-12),
        lower_bound_makespan=lb,
    )
