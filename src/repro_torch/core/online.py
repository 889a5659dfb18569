"""Online (dynamic-arrival) scheduling — beyond-paper extension.

The paper schedules a batch of jobs known at t=0 (§4: "In the beginning of
a scheduling horizon T ... a set of jobs waiting to be scheduled").
Production clusters see arrivals over time.  In the unified API this is
simply a :class:`~repro_torch.core.api.ScheduleRequest` with ``arrivals`` set:
every registered policy then runs the shared epoch loop
(:func:`~repro_torch.core.api.schedule_arrivals`), which

  * visits jobs in (arrival, G_j) order;
  * advances the real-time clocks to each arrival instant (a GPU idle
    before an arrival cannot have been used earlier);
  * places each job against the live busy-time clocks — for SJF-BCO with
    the finish-minimising pack-or-spread choice between FA-FFP and LBSGF
    (gang scheduling forbids migration, Eq. 3, so placements are final).

The end-to-end makespan is evaluated by the same contention simulator
(``simulate(..., arrivals=...)``).  This module keeps the arrival-stream
helpers (Poisson streams, request building, the run_online convenience).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.api import ScheduleRequest, get_policy
from repro_torch.core.cluster import Cluster
from repro_torch.core.contention import tau_backend
from repro_torch.core.jobs import Job
from repro_torch.core.simulator import Assignment, simulate

__all__ = ["ArrivingJob", "poisson_arrivals", "stream_request", "run_online"]


@dataclasses.dataclass(frozen=True)
class ArrivingJob:
    job: Job
    arrival: int          # slot of arrival


def poisson_arrivals(jobs: list[Job], rate: float = 0.5,
                     seed: int = 0) -> list[ArrivingJob]:
    """Turn a §7 workload into a Poisson arrival stream (rate jobs/slot)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=len(jobs))
    times = np.floor(np.cumsum(gaps)).astype(int)
    return [ArrivingJob(j, int(t)) for j, t in zip(jobs, times)]


def stream_request(cluster: Cluster, stream: list[ArrivingJob],
                   horizon: int = 10**6, u: float = 1.5,
                   params: dict | None = None) -> ScheduleRequest:
    """Build a :class:`ScheduleRequest` from an arrival stream.

    Jobs are ordered by jid so simulator indexing (``jobs[j]`` for
    assignment entry j) lines up with the job ids."""
    ordered = sorted(stream, key=lambda a: a.job.jid)
    return ScheduleRequest(
        cluster=cluster,
        jobs=[a.job for a in ordered],
        arrivals=np.asarray([a.arrival for a in ordered], dtype=np.int64),
        horizon=horizon, u=u, params=params or {})


def run_online(cluster: Cluster, stream: list[ArrivingJob],
               horizon: int = 10**6, policy: str = "sjf-bco",
               device="cuda") -> tuple[Assignment, "object"]:
    """Schedule an arrival stream and simulate (arrival-constrained);
    returns (assignment, SimResult).

    ``device`` (resolved by :func:`repro_torch.resolve_device`, which
    raises when CUDA is asked for and absent) says where the pricing
    runs, as in :func:`~repro_torch.core.scenario.run_scenario`: on a
    CUDA device the ``"batched"`` engine prices each decision's
    candidates as one stack through the tau kernel, with
    ``placement="columnar"`` and ``columnar_backend="kernel"``; on the
    CPU the reference's defaults hold.  The schedule is bit-identical
    either way.  A preemptive policy's segments are simulated with their
    quotas (the reference's ``run_online`` omits them and raises on a
    segmented schedule)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    params = {"device": dev}
    if on_card:
        params.update(engine="batched", placement="columnar",
                      columnar_backend="kernel")
    request = stream_request(cluster, stream, horizon, params=params)
    with (tau_backend("kernel", dev) if on_card
          else contextlib.nullcontext()):
        schedule = get_policy(policy)(request)
    sim = simulate(cluster, request.jobs, schedule.assignment,
                   arrivals=request.arrivals, quotas=schedule.quotas)
    return schedule.assignment, sim
