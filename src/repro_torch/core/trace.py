"""Trace-replay arrivals: step a recorded GPU-cluster job log through the
scheduler (ROADMAP item 4, first slice).

A trace is a CSV with Alibaba ``cluster-trace-gpu-2020``-style columns:
one row per job, ``start_time`` (the arrival instant, seconds/slots),
``plan_gpu`` (requested GPU share in GPU-percent -- 100 per device, as in
the Alibaba schema; 200 = a 2-GPU gang), ``iterations`` (F_j) and
``grad_size`` (m_j, GB).  Optional columns ``batch``/``dt_fwd``/
``dt_bwd``/``lam`` override the per-iteration cost terms; absent columns
fall back to mid-range Philly-workload constants, so a minimal 4-column
log replays out of the box.

Two consumers share :func:`load_trace`:

  * the declarative scenario layer -- ``WorkloadSpec(kind="trace",
    path=...)`` builds the job list and ``ArrivalSpec(kind="trace",
    path=...)`` the arrival vector, so :func:`repro_torch.core.scenario.run_scenario`
    replays the log end-to-end;
  * the service daemon -- :func:`replay_trace` admits each row at its
    recorded arrival, so a long-running daemon steps the identical
    stream (placements match ``schedule_arrivals`` on the same trace by
    the daemon's identity guarantee).

A bundled sample lives at ``examples/sample_trace.csv``.
"""
from __future__ import annotations

import csv
import dataclasses

import numpy as np

from repro_torch.core.jobs import Job

__all__ = ["TRACE_COLUMNS", "load_trace", "replay_trace"]

# Required header names; optional extras: batch, dt_fwd, dt_bwd, lam.
TRACE_COLUMNS = ("start_time", "plan_gpu", "iterations", "grad_size")

# Philly-workload mid-range fallbacks for traces that only record the
# (arrival, shape, length) columns (see repro_torch.core.jobs.philly_workload).
_DEFAULT_BATCH = 32
_DEFAULT_DT_FWD = 3.0e-4
_DEFAULT_DT_BWD = 8.0e-3


def load_trace(path: str) -> tuple[list[Job], np.ndarray]:
    """Parse a trace CSV into ``(jobs, arrivals)``.

    Rows are sorted by ``start_time`` (ties keep file order) and jobs are
    renumbered so ``jid == index`` -- the invariant the simulator's
    assignment indexing and the scheduler's ``(arrival, G_j, jid)`` visit
    order rely on.  Arrivals are floored to integer slots, shifted so the
    first arrival lands at slot 0 (a trace excerpt's absolute epoch is
    irrelevant to scheduling).
    """
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh)
        header = reader.fieldnames or []
        missing = [c for c in TRACE_COLUMNS if c not in header]
        if missing:
            raise ValueError(
                f"trace {path!r} is missing required columns {missing}; "
                f"expected at least {list(TRACE_COLUMNS)} (got {header})")
        rows = list(reader)
    if not rows:
        raise ValueError(f"trace {path!r} has no job rows")
    parsed = []
    for i, row in enumerate(rows):
        try:
            start = float(row["start_time"])
            plan_gpu = float(row["plan_gpu"])
            iters = int(float(row["iterations"]))
            grad = float(row["grad_size"])
        except (TypeError, ValueError) as exc:
            raise ValueError(f"trace {path!r} row {i + 2}: {exc}") from None
        # Alibaba logs GPU shares in percent; fractional-GPU requests
        # round up to one whole device (gang scheduling is device-whole).
        gpus = max(1, int(round(plan_gpu / 100.0)))
        job = Job(
            jid=0, num_gpus=gpus, iters=iters, grad_size=grad,
            batch=int(float(row.get("batch") or _DEFAULT_BATCH)),
            dt_fwd=float(row.get("dt_fwd") or _DEFAULT_DT_FWD),
            dt_bwd=float(row.get("dt_bwd") or _DEFAULT_DT_BWD),
            lam=float(row.get("lam") or 1.0),
        )
        parsed.append((start, i, job))
    parsed.sort(key=lambda t: (t[0], t[1]))
    jobs = [dataclasses.replace(job, jid=i)
            for i, (_, _, job) in enumerate(parsed)]
    arrivals = np.floor(np.asarray([s for s, _, _ in parsed])).astype(np.int64)
    arrivals -= arrivals[0]
    return jobs, arrivals


def replay_trace(daemon, path: str, tenant: str = "default") -> list:
    """Admit every trace row into a service daemon at its recorded arrival.

    ``daemon`` is a :class:`repro_torch.service.daemon.Daemon` (or anything with
    its ``admit(job, arrival, tenant)`` surface, e.g. a
    :class:`~repro_torch.service.api.SchedulerService`'s ``.daemon``).  Returns
    the admitted :class:`~repro_torch.service.state.JobRecord` list in arrival
    order; the caller steps/drains the daemon as usual.
    """
    jobs, arrivals = load_trace(path)
    return [daemon.admit(job, arrival=int(t), tenant=tenant)
            for job, t in zip(jobs, arrivals)]
