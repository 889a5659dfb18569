"""Public facade of the scheduler service.

:class:`SchedulerService` is the narrow, stable surface a client sees:
``submit`` / ``cancel`` / ``status`` / ``step`` / ``drain`` / ``recover``.
It composes the pieces underneath -- :class:`~repro_torch.service.queue.QueueManager`,
:class:`~repro_torch.service.daemon.Daemon`, a journal store from
:mod:`repro_torch.service.store` -- and is layered strictly on
:mod:`repro_torch.core.api`: policies and choosers are resolved through the core
registries, placements go through the shared
:class:`~repro_torch.core.api.PlacementState`, and ``drain`` returns the exact
:class:`~repro_torch.core.api.ScheduleResult` shape every registered policy
emits.  No new scheduling entrypoints are introduced; for any trace, ::

    svc = SchedulerService(cluster, policy="sjf-bco")
    handles = [svc.submit(SubmitRequest(job, arrival)) for ...]
    schedule, sim = svc.drain()

yields a ``schedule`` identical (assignment, starts, finishes) to ::

    get_policy("sjf-bco")(ScheduleRequest(cluster, jobs, arrivals=...))

because both run the same chooser over the same state in the same order
(``tests/test_torch_service.py`` holds this, including across a
simulated crash/recovery).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.api import ScheduleResult
from repro_torch.core.cluster import Cluster
from repro_torch.core.jobs import Job
from repro_torch.core.simulator import SimResult
from repro_torch.service.daemon import Daemon, VirtualClock
from repro_torch.service.queue import QueueManager, TenantConfig
from repro_torch.service.state import JobState
from repro_torch.service.store import open_store

__all__ = ["SubmitRequest", "JobHandle", "JobStatus", "SchedulerService"]


@dataclasses.dataclass(frozen=True)
class SubmitRequest:
    """One submission: the job spec (its ``jid`` is ignored -- the service
    assigns daemon-wide ids), its arrival slot, and the owning tenant."""

    job: Job
    arrival: int = 0
    tenant: str = "default"


@dataclasses.dataclass(frozen=True)
class JobHandle:
    """Opaque ticket returned by :meth:`SchedulerService.submit`."""

    jid: int
    tenant: str


@dataclasses.dataclass(frozen=True)
class JobStatus:
    """Point-in-time view of one job's lifecycle and placement."""

    jid: int
    tenant: str
    state: JobState
    arrival: int
    gpus: "tuple[int, ...] | None"
    start: "float | None"
    finish: "float | None"


class SchedulerService:
    """Long-running scheduling service over one cluster.

    ``policy``/``params`` configure the default tenant; ``tenants`` maps
    tenant names to their own :class:`~repro_torch.service.queue.TenantConfig`.
    ``store_path=None`` keeps the journal in memory; a path gets a durable
    stdlib-sqlite journal that :meth:`recover` can replay after a crash.
    ``device`` (default ``"cuda"``; resolved by
    :func:`repro_torch.resolve_device`, which raises without a card) is
    where the daemon prices its decisions: the tau kernel on a CUDA
    device, the reference's defaults on ``"cpu"``.  Remaining keyword
    arguments (``u``, ``horizon``, ``engine``, ``feedback``,
    ``monitor_every``, ``clock``) flow to
    :class:`~repro_torch.service.daemon.Daemon`.
    """

    def __init__(self, cluster: Cluster, *, policy: str = "sjf-bco",
                 params: "dict | None" = None,
                 tenants: "dict[str, TenantConfig] | None" = None,
                 store_path: "str | None" = None,
                 round_slots: int = 1, max_batch: "int | None" = None,
                 _store=None, device="cuda", **daemon_kwargs):
        default = TenantConfig(policy=policy,
                               params=tuple(sorted((params or {}).items())))
        queue = QueueManager(default, tenants, round_slots=round_slots,
                             max_batch=max_batch)
        store = _store if _store is not None else open_store(store_path)
        self.daemon = Daemon(cluster, store, queue, device=device,
                             **daemon_kwargs)

    # -- client surface ---------------------------------------------------

    def submit(self, request: SubmitRequest) -> JobHandle:
        """Admit one job; it is journaled and queued for the next round."""
        record = self.daemon.admit(request.job, request.arrival,
                                   request.tenant)
        return JobHandle(jid=record.jid, tenant=record.tenant)

    def cancel(self, handle: "JobHandle | int") -> bool:
        """Withdraw a job that has not been placed yet; False otherwise."""
        jid = handle.jid if isinstance(handle, JobHandle) else int(handle)
        return self.daemon.cancel(jid)

    def status(self, handle: "JobHandle | int",
               refresh: bool = True) -> JobStatus:
        """The job's current lifecycle state and placement.

        ``refresh=True`` first runs the monitor loop up to the current
        virtual clock, so completions that already happened in virtual
        time are reflected (``RUNNING -> DONE``)."""
        if refresh:
            self.daemon.monitor()
        jid = handle.jid if isinstance(handle, JobHandle) else int(handle)
        record = self.daemon.records[jid]
        return JobStatus(
            jid=record.jid, tenant=record.tenant, state=record.state,
            arrival=record.arrival,
            gpus=None if record.gpus is None
            else tuple(int(g) for g in record.gpus),
            start=record.start, finish=record.finish)

    def step(self) -> bool:
        """Run one scheduling round; False when the queue is empty."""
        return self.daemon.step()

    def drain(self, sim_horizon: int = 10**7
              ) -> "tuple[ScheduleResult, SimResult]":
        """Schedule everything queued, run virtual-time execution to
        completion, and return ``(schedule, sim)`` -- the same result pair
        a one-shot policy call plus :func:`~repro_torch.core.simulator.simulate`
        would produce for the identical trace."""
        return self.daemon.drain(sim_horizon=sim_horizon)

    def table(self) -> str:
        """Human-readable state table (jid, tenant, state, placement)."""
        rows = ["  jid tenant     state      gpus                start"
                "      finish"]
        for jid in sorted(self.daemon.records):
            r = self.daemon.records[jid]
            gpus = ("-" if r.gpus is None
                    else ",".join(str(int(g)) for g in r.gpus[:6])
                    + ("..." if len(r.gpus) > 6 else ""))
            start = "-" if r.start is None else f"{r.start:.1f}"
            finish = "-" if r.finish is None else f"{r.finish:.1f}"
            rows.append(f"  {jid:3d} {r.tenant:<10.10s} {r.state.value:<10s} "
                        f"{gpus:<19s} {start:>10s} {finish:>11s}")
        return "\n".join(rows)

    def close(self) -> None:
        """Close the journal store (flushes a sqlite WAL)."""
        self.daemon.store.close()

    # -- recovery ---------------------------------------------------------

    @classmethod
    def recover(cls, cluster: "Cluster | None", store_path: str, *,
                policy: str = "sjf-bco", params: "dict | None" = None,
                tenants: "dict[str, TenantConfig] | None" = None,
                round_slots: int = 1, max_batch: "int | None" = None,
                _store=None, device="cuda",
                **daemon_kwargs) -> "SchedulerService":
        """Rebuild a service from a journal left by a dead daemon.

        Replays the journal (see :meth:`repro_torch.service.daemon.Daemon.recover`),
        re-enqueues in-flight work, and returns a service ready to
        ``step``/``drain`` -- with placements and busy-time clocks
        bit-identical to the crashed process's.  ``cluster`` may be
        ``None``: the journal's opening ``cluster`` record reconstructs
        it exactly, heterogeneous speed/link arrays included."""
        service = cls.__new__(cls)
        default = TenantConfig(policy=policy,
                               params=tuple(sorted((params or {}).items())))
        queue = QueueManager(default, tenants, round_slots=round_slots,
                             max_batch=max_batch)
        store = _store if _store is not None else open_store(store_path)
        service.daemon = Daemon.recover(cluster, store, queue,
                                        device=device, **daemon_kwargs)
        return service

    @property
    def clock(self) -> VirtualClock:
        """The daemon's virtual clock."""
        return self.daemon.clock
