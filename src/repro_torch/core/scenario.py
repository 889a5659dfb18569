"""Declarative scenarios: cluster + workload + arrival process + policy,
run end-to-end through the unified scheduling API.

A :class:`Scenario` is a plain-data description of one experiment — the
§7 Philly setting, an online Poisson stream, a contention sweep point —
that :func:`run_scenario` turns into (schedule, simulation, contention
stats) with one call::

    report = run_scenario(Scenario(
        cluster=ClusterSpec(num_servers=8, seed=1),
        workload=WorkloadSpec(num_jobs=40, seed=1),
        policy="sjf-bco", horizon=1200))
    print(report.sim.makespan, report.contention.peak)

Every spec is seeded and frozen, so a scenario is a reproducible value:
two runs of the same Scenario produce identical reports.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from repro_torch import obs, resolve_device
from repro_torch.core.api import ScheduleRequest, ScheduleResult, get_policy
from repro_torch.core.cluster import Cluster, _draw_hetero, philly_cluster
from repro_torch.core.contention import tau_backend
from repro_torch.core.jobs import Job, philly_workload
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.core.trace import load_trace

__all__ = ["ClusterSpec", "WorkloadSpec", "ArrivalSpec", "Scenario",
           "ContentionStats", "RunReport", "run_scenario", "schedule_on"]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Cluster description: explicit ``capacities`` or a seeded Philly
    draw of ``num_servers`` servers; optional contention-constant
    overrides (xi1/xi2/alpha/bandwidths) and per-server heterogeneity
    draws -- ``speed_tiers`` ``((speed, weight), ...)`` assigns each
    server's GPUs one drawn speed tier, ``link_classes`` ``((bandwidth,
    kind, weight), ...)`` draws each server's uplink class (``kind`` is
    ``"shared"`` or ``"isolated"``; see :mod:`repro_torch.core.cluster`)."""

    num_servers: int = 20
    seed: int = 0
    capacities: tuple[int, ...] | None = None
    overrides: tuple[tuple[str, float], ...] = ()
    speed_tiers: tuple[tuple[float, float], ...] | None = None
    link_classes: tuple[tuple[float, str, float], ...] | None = None

    def build(self) -> Cluster:
        if self.capacities is not None:
            caps = tuple(int(c) for c in self.capacities)
            rng = np.random.default_rng(self.seed)
            cluster = Cluster(capacities=caps, **_draw_hetero(
                rng, caps, self.speed_tiers, self.link_classes))
        else:
            cluster = philly_cluster(self.num_servers, seed=self.seed,
                                     speed_tiers=self.speed_tiers,
                                     link_classes=self.link_classes)
        if self.overrides:
            valid = {f.name for f in dataclasses.fields(Cluster)}
            unknown = sorted(k for k, _ in self.overrides if k not in valid)
            if unknown:
                raise ValueError(
                    f"unknown Cluster override field(s) {unknown}; valid "
                    f"fields are {sorted(valid)} (per-device heterogeneity "
                    "goes in ClusterSpec.speed_tiers / link_classes, not "
                    "overrides)")
            cluster = dataclasses.replace(cluster, **dict(self.overrides))
        return cluster


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Workload description.  ``kind="philly"`` draws the §7 Philly-mix
    jobs; ``kind="trace"`` parses the job shapes out of a recorded CSV
    log at ``path`` (see :mod:`repro_torch.core.trace` -- pair it with an
    ``ArrivalSpec(kind="trace")`` on the same path to replay the recorded
    arrivals too).  ``num_jobs`` truncates (jobs are re-numbered so
    jid == index, which the simulator's assignment indexing relies on)."""

    kind: str = "philly"
    seed: int = 0
    num_jobs: int | None = None
    lam: float = 1.0
    path: str | None = None

    def build(self) -> list[Job]:
        if self.kind == "trace":
            if self.path is None:
                raise ValueError("trace workload needs a path")
            jobs, _ = load_trace(self.path)
        elif self.kind == "philly":
            jobs = philly_workload(seed=self.seed, lam=self.lam)
        else:
            raise ValueError(f"unknown workload kind {self.kind!r}")
        if self.num_jobs is not None:
            jobs = [dataclasses.replace(j, jid=i)
                    for i, j in enumerate(jobs[: self.num_jobs])]
        return jobs


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Arrival process.  ``kind="poisson"`` draws i.i.d. exponential gaps
    at ``rate`` jobs/slot; ``kind="pareto"`` draws heavy-tailed Pareto
    gaps (bursty: many near-zero gaps punctuated by long lulls) with tail
    index ``shape``, mean-normalised so ``rate`` still sets the long-run
    jobs/slot; ``kind="fixed"`` uses explicit ``times``;
    ``kind="trace"`` replays the recorded ``start_time`` column of the
    CSV log at ``path`` (see :mod:`repro_torch.core.trace` -- typically paired
    with a ``WorkloadSpec(kind="trace")`` on the same path, so the job
    count matches by construction)."""

    kind: str = "poisson"
    rate: float = 0.5
    seed: int = 0
    times: tuple[int, ...] | None = None
    path: str | None = None
    shape: float = 1.5         # Pareto tail index (finite mean needs > 1)

    def build(self, jobs: list[Job]) -> np.ndarray:
        if self.kind == "trace":
            if self.path is None:
                raise ValueError("trace arrivals need a path")
            _, arrivals = load_trace(self.path)
            if len(arrivals) < len(jobs):
                raise ValueError(
                    f"trace {self.path!r} has {len(arrivals)} arrivals "
                    f"for {len(jobs)} jobs")
            return arrivals[: len(jobs)]
        if self.kind == "fixed":
            if self.times is None or len(self.times) != len(jobs):
                raise ValueError("fixed arrivals need one time per job")
            return np.asarray(self.times, dtype=np.int64)
        if self.kind == "pareto":
            # Lomax (Pareto II) inter-arrival gaps: mean is scale/(shape-1)
            # for shape > 1, so scale = (shape-1)/rate keeps the long-run
            # arrival rate at ``rate`` while the tail index ``shape``
            # controls burstiness (smaller -> heavier tail).
            if self.shape <= 1.0:
                raise ValueError(
                    f"pareto arrivals need shape > 1 for a finite mean "
                    f"gap (got shape={self.shape})")
            rng = np.random.default_rng(self.seed)
            scale = (self.shape - 1.0) / self.rate
            gaps = rng.pareto(self.shape, size=len(jobs)) * scale
            return np.floor(np.cumsum(gaps)).astype(np.int64)
        if self.kind != "poisson":
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1.0 / self.rate, size=len(jobs))
        return np.floor(np.cumsum(gaps)).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One reproducible experiment: what to schedule, with which policy."""

    cluster: ClusterSpec = ClusterSpec()
    workload: WorkloadSpec = WorkloadSpec()
    arrivals: ArrivalSpec | None = None
    policy: str = "sjf-bco"
    policy_params: tuple[tuple[str, object], ...] = ()
    horizon: int = 1200
    u: float = 1.5
    name: str = ""


@dataclasses.dataclass(frozen=True)
class ContentionStats:
    """Per-slot contention summary of a simulated run (from the
    piecewise-constant simulator events).

    The event stream includes zero-active idle windows (waiting for the
    next arrival), so every time-weighted statistic here is weighted by
    wall-clock time over the whole run -- an idle cluster pulls
    ``mean_active``/``mean`` down instead of being silently skipped."""

    peak: int                  # max p_j[t] over the run (Eq. 6)
    mean: float                # time-weighted mean of per-window max p
    mean_active: float         # time-weighted mean #concurrent jobs
    contended_frac: float      # fraction of wall-clock time with p >= 2

    @classmethod
    def from_sim(cls, sim: SimResult) -> "ContentionStats":
        total = sum(e.dt for e in sim.events)
        if not total:
            return cls(peak=sim.peak_contention, mean=0.0,
                       mean_active=0.0, contended_frac=0.0)
        mean_active = sum(e.active * e.dt for e in sim.events) / total
        contended = sum(e.dt for e in sim.events if e.contention >= 2)
        return cls(peak=sim.peak_contention, mean=sim.mean_contention,
                   mean_active=float(mean_active),
                   contended_frac=contended / total)


@dataclasses.dataclass(frozen=True)
class RunReport:
    """Everything :func:`run_scenario` learned about one scenario."""

    scenario: Scenario
    schedule: ScheduleResult
    sim: SimResult
    contention: ContentionStats

    @property
    def makespan(self) -> float:
        return self.sim.makespan

    @property
    def avg_jct(self) -> float:
        return self.sim.avg_jct

    @property
    def avg_queueing_delay(self) -> float:
        """Mean start - arrival over completed jobs (time spent waiting
        for GPUs; ``avg_jct == avg_queueing_delay + mean service time``)."""
        return self.sim.avg_queueing_delay


def build_request(scenario: Scenario) -> ScheduleRequest:
    """Materialise the scenario's specs into a :class:`ScheduleRequest`."""
    cluster = scenario.cluster.build()
    jobs = scenario.workload.build()
    arrivals = (scenario.arrivals.build(jobs)
                if scenario.arrivals is not None else None)
    return ScheduleRequest(cluster=cluster, jobs=jobs, arrivals=arrivals,
                           horizon=scenario.horizon, u=scenario.u,
                           params=dict(scenario.policy_params))


def schedule_on(request: ScheduleRequest, policy: str,
                device="cuda") -> ScheduleResult:
    """``get_policy(policy)(request)`` with the scheduler's array work on
    ``device`` (resolved by :func:`repro_torch.resolve_device`).  On a
    CUDA device the request's unset params default to
    ``placement="columnar"`` with ``columnar_backend="kernel"`` and the
    stack-model tau backend is ``"kernel"``, so the pool, score and tau
    kernels carry the step math; on the CPU the reference's defaults hold
    (scalar placement, NumPy throughout).  Every placement and backend is
    bit-identical in float64, so the device changes where the work runs,
    not the schedule."""
    dev = resolve_device(device)
    params = dict(request.params)
    params.setdefault("device", dev)
    on_card = dev.type == "cuda"
    if on_card:
        params.setdefault("placement", "columnar")
        params.setdefault("columnar_backend", "kernel")
    request = dataclasses.replace(request, params=params)
    with (tau_backend("kernel", dev) if on_card
          else contextlib.nullcontext()), obs.span("sched.policy"):
        return get_policy(policy)(request)


def run_scenario(scenario: Scenario, sim_horizon: int = 10**7,
                 device="cuda") -> RunReport:
    """Schedule and simulate one scenario: the Fig. 3 loop end-to-end.

    ``device`` says where the scheduler's array work runs
    (:func:`schedule_on`; it raises when CUDA is asked for and absent).
    The device changes where the work runs, not the report.  The
    simulator is host NumPy on both."""
    request = build_request(scenario)
    schedule = schedule_on(request, scenario.policy, device)
    sim = simulate(request.cluster, request.jobs, schedule.assignment,
                   horizon=sim_horizon, arrivals=request.arrivals,
                   quotas=schedule.quotas)
    return RunReport(scenario=scenario, schedule=schedule, sim=sim,
                     contention=ContentionStats.from_sim(sim))
