"""The scheduler daemon: a crash-recoverable event loop over the online
scheduling path.

One :class:`Daemon` owns the persistent pieces a long-running scheduler
needs -- a live :class:`~repro_torch.core.api.PlacementState`, the write-ahead
journal (:mod:`repro_torch.service.store`), the queue manager, a virtual clock
-- and drives *scheduling rounds*: pop the next arrival batch, advance the
clocks, run each tenant's registered online chooser
(:func:`repro_torch.core.api.get_chooser`), journal every transition.  Because
the chooser, the visit order ``(arrival, G_j, jid)`` and the busy-time
accounting are literally the same code
:func:`repro_torch.core.api.schedule_arrivals` runs, the daemon's placements are
decision-for-decision identical to a one-shot ``schedule_arrivals`` call
on the same trace -- the service is a recoverable shell around the
paper's online path, not a fork of its semantics (asserted by
``tests/test_torch_service.py``).

Execution is virtual-time: the *monitor loop* runs
:func:`repro_torch.core.simulator.simulate` over the committed assignment up to
the current clock and folds completions back (``RUNNING -> DONE``).  With
``feedback="actual"`` each completion is also fed into the incremental
engines via :meth:`~repro_torch.core.api.PlacementState.observe_finish`, so
later placements price contention against observed finishes instead of
the rho-hat estimates (an opt-in extension: it deliberately changes
decisions, so the identity guarantee holds only for the default
``feedback="estimate"``).

Crash recovery (:meth:`Daemon.recover`) is pure journal replay: rebuild
the job records, re-commit journaled placements -- with the exact
``(gpus, rho, start)`` floats, in journal order, so U/R clocks come back
bit-for-bit -- and re-enqueue anything caught mid-``PLACING``; the
chooser then re-derives the same placement the crashed process was about
to make.  Stateful choosers (RAND) journal their rng state inside every
outcome transition, and replay restores it, so even stochastic policies
recover decision-for-decision.

On a CUDA device (the default; ``device="cpu"`` runs the reference's
defaults) every chooser run -- each decision of :meth:`Daemon.step`,
including the re-decision of a job a crash caught mid-``PLACING`` --
prices its candidates through the tau kernel: an unset ``engine`` becomes
``"batched"``, so a decision's candidates form one ``[C, P+1, S]`` stack,
and the chooser runs inside ``tau_backend("kernel", device)``.  That
switch is module-wide, so it is entered per decision and left between
steps.  Every engine and backend is bit-identical in float64: the device
moves the pricing, never a decision, a journal entry or a clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

from repro_torch import obs, resolve_device
from repro_torch.core.api import (PlacementState, ScheduleResult, finalize,
                                  get_chooser)
from repro_torch.core.cluster import Cluster
from repro_torch.core.contention import tau_backend
from repro_torch.core.jobs import Job
from repro_torch.core.preempt import evict as apply_evict
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.service.queue import QueueManager
from repro_torch.service.state import TERMINAL, JobRecord, JobState
from repro_torch.service.store import MemoryStore

__all__ = ["VirtualClock", "Daemon", "FEEDBACK_MODES"]

FEEDBACK_MODES = ("estimate", "actual")


class VirtualClock:
    """Injectable monotone clock in simulator slots.

    The daemon advances it to each round's arrival slot; journal
    timestamps come from it, so tests (and the fault-injection loop) see
    fully deterministic journals.  Inject a wall-clock adapter (anything
    with ``now()``/``advance(t)``) to stamp real time instead."""

    def __init__(self, t0: float = 0.0):
        self._now = float(t0)

    def now(self) -> float:
        """Current virtual time (slots)."""
        return self._now

    def advance(self, t: float) -> None:
        """Move forward to ``t`` (never backwards)."""
        self._now = max(self._now, float(t))


class Daemon:
    """Event loop + journal + recovery for one cluster's scheduler.

    ``device`` (default ``"cuda"``, resolved by
    :func:`repro_torch.resolve_device`, which raises without a card) is
    where the chooser runs price their candidates; see the module
    docstring."""

    def __init__(self, cluster: Cluster, store=None,
                 queue: "QueueManager | None" = None, *,
                 u: float = 1.5, horizon: int = 1200,
                 engine: "str | None" = None,
                 feedback: str = "estimate",
                 monitor_every: int = 0,
                 clock: "VirtualClock | None" = None,
                 device="cuda"):
        if feedback not in FEEDBACK_MODES:
            raise ValueError(f"unknown feedback mode {feedback!r}; "
                             f"choose from {FEEDBACK_MODES}")
        self.device = resolve_device(device)
        if engine is None and self.device.type == "cuda":
            engine = "batched"
        self.cluster = cluster
        self.store = store if store is not None else MemoryStore()
        # NB: not ``queue or ...`` -- an empty QueueManager is falsy (len 0).
        self.queue = queue if queue is not None else QueueManager()
        self.u = float(u)
        self.horizon = int(horizon)
        self.feedback = feedback
        # 0 = lazy (monitor only on status/drain); k = every k rounds.
        # feedback="actual" needs completions before each round to act on
        # them, so it forces per-round monitoring.
        self.monitor_every = 1 if feedback == "actual" else int(monitor_every)
        self.clock = clock or VirtualClock()
        if len(self.store) == 0:
            # A fresh journal opens with the cluster description, so
            # recover() can rebuild heterogeneous clusters (per-GPU
            # speeds, per-server link classes) exactly from the journal
            # alone instead of being handed the object out-of-band.
            self.store.append("cluster", -1, cluster.to_payload(),
                              ts=self.clock.now())
        self.state = PlacementState(cluster, engine=engine)
        self.state.commit_hook = self._capture_commit
        self.state.evict_hook = self._capture_evict
        self.records: dict[int, JobRecord] = {}
        self.jobs: list[Job] = []          # jid-indexed (jid == list index)
        self.arrivals: list[int] = []
        self.rounds = 0
        self.decision_latencies: list[float] = []   # seconds, per chooser run
        self._choosers: dict[str, object] = {}
        # One chooser decision may mutate the state several times (a
        # preemptive chooser evicts, re-places the residual, then places
        # the arrival); the hooks record every mutation in order so step()
        # can journal the whole decision as one PLACING..RUNNING bracket.
        self._events: list[tuple] = []
        self._mutations = 0                # total state mutations ever
        self._sim_cache: "tuple | None" = None      # ((mutations, limit), sim)

    # -- submission -------------------------------------------------------

    def admit(self, job: Job, arrival: int = 0,
              tenant: str = "default") -> JobRecord:
        """Journal + enqueue one submission; the job is renumbered so its
        jid is the daemon-wide submission index (the invariant simulator
        indexing and ``schedule_arrivals`` identity both rely on)."""
        if arrival < 0:
            raise ValueError("arrival slot must be >= 0")
        jid = len(self.jobs)
        job = dataclasses.replace(job, jid=jid)
        record = JobRecord(jid=jid, tenant=tenant, job=job,
                           arrival=int(arrival))
        self.jobs.append(job)
        self.arrivals.append(int(arrival))
        self.records[jid] = record
        self.store.append("submit", jid,
                          {"tenant": tenant, "arrival": int(arrival),
                           "job": dataclasses.asdict(job)},
                          ts=self.clock.now())
        self._transition(record, JobState.QUEUED)
        self.queue.push(record)
        return record

    def cancel(self, jid: int) -> bool:
        """Withdraw a not-yet-placed job; False once it is beyond QUEUED
        (gang scheduling is non-preemptive, Eq. 3)."""
        record = self.records.get(jid)
        if record is None or record.state not in (JobState.PENDING,
                                                  JobState.QUEUED):
            return False
        self.queue.cancel(jid)
        self._transition(record, JobState.CANCELLED)
        return True

    # -- the event loop ---------------------------------------------------

    def step(self) -> bool:
        """Run one scheduling round; False when nothing is queued.

        A round pops the queue manager's next arrival batch, journals an
        ``advance`` to the batch's latest arrival slot, and for each job
        (already in ``schedule_arrivals``'s visit order) journals
        ``PLACING``, advances the real-time clocks to its arrival, runs
        the tenant's chooser against the shared placement state, and
        journals the outcome (``RUNNING`` with the exact committed
        placement, or ``FAILED``)."""
        batch = self.queue.next_batch()
        if not batch:
            return False
        with obs.span("daemon.round"):
            self.rounds += 1
            t_round = max(r.arrival for r in batch)
            self.store.append("advance", -1, {"t": t_round},
                              ts=self.clock.now())
            self.clock.advance(t_round)
            theta = float(self.horizon)
            for record in batch:
                with obs.span("daemon.decide"):
                    self._decide(record, theta)
            if self.monitor_every and self.rounds % self.monitor_every == 0:
                self.monitor()
        return True

    def _decide(self, record: JobRecord, theta: float) -> None:
        """One decision of a round: journal ``PLACING``, run the tenant's
        chooser, journal its outcome and ``decided``."""
        chooser = self._chooser_for(record.tenant)
        self._transition(record, JobState.PLACING)
        self.state.advance_to(record.arrival)
        self._events = []
        sp = obs.open_span("daemon.chooser") if obs.on else -1
        t0 = time.perf_counter()
        with self._pricing():
            ok = chooser(self.state, record.job, theta)
        self.decision_latencies.append(time.perf_counter() - t0)
        if sp >= 0:
            obs.close_span(sp)
        # Stateful choosers (RAND) snapshot their post-decision rng
        # state INSIDE the outcome transition: one atomic append, so
        # there is no crash window between the outcome and the state
        # the next decision must start from.
        get_state = getattr(chooser, "get_state", None)
        extra = {} if get_state is None else {"rng": get_state()}
        if not ok:
            if self._events:
                raise RuntimeError(
                    f"chooser mutated the placement state while failing "
                    f"to place job {record.jid} (trial preemption must "
                    "run on a clone)")
            self._transition(record, JobState.FAILED, **extra)
            self.store.append("decided", record.jid, {}, ts=self.clock.now())
            return
        events = self._events
        if sum(1 for ev in events
               if ev[0] == "commit" and ev[1] == record.jid) != 1:
            raise RuntimeError(
                f"chooser must commit job {record.jid} exactly once "
                f"while placing it (got events "
                f"{[(e[0], getattr(e[1], 'jid', e[1])) for e in events]})")
        # Journal the decision's event stream in journal == commit
        # order (U += charges are float-order-sensitive, so replay
        # must re-commit in the live order); the closing ``decided``
        # record makes the bracket atomic: replay applies all of it
        # or none of it (_replay buffers between PLACING and the
        # ``decided``).
        for ev in events:
            if ev[0] == "evict":
                _, vjob, t_ev, residual = ev
                vrec = self.records[vjob.jid]
                if vrec.state is not JobState.RUNNING:
                    raise RuntimeError(
                        f"chooser evicted job {vjob.jid} in state "
                        f"{vrec.state.value}; preemptive policies need "
                        "est-consistent completion feedback (run with "
                        'monitor_every=0 or feedback="actual")')
                kind = "resize" \
                    if residual.num_gpus != vjob.num_gpus else "evict"
                self.store.append(kind, vjob.jid,
                                  {"t": t_ev,
                                   "iters": residual.iters,
                                   "num_gpus": residual.num_gpus},
                                  ts=self.clock.now())
                self._transition(vrec, JobState.QUEUED)
                vrec.job = residual
            elif ev[1] == record.jid:       # the arrival itself
                _, jid, gpus, rho, start = ev
                record.gpus, record.rho, record.start = gpus, rho, start
                self._transition(record, JobState.RUNNING,
                                 gpus=[int(g) for g in gpus],
                                 rho=rho, start=start, **extra)
            else:         # the victim's residual re-placement
                _, jid2, gpus2, rho2, start2 = ev
                vrec = self.records[jid2]
                self._transition(vrec, JobState.PLACING)
                vrec.gpus, vrec.rho, vrec.start = gpus2, rho2, start2
                self._transition(vrec, JobState.RUNNING,
                                 gpus=[int(g) for g in gpus2],
                                 rho=rho2, start=start2)
        self.store.append("decided", record.jid, {}, ts=self.clock.now())

    def drain(self, sim_horizon: int = 10**7
              ) -> "tuple[ScheduleResult, SimResult]":
        """Run rounds until the queue is empty, then let the virtual-time
        execution run to completion; returns the frozen schedule (the
        same :func:`~repro_torch.core.api.finalize` shape every policy emits)
        and the final simulation."""
        while self.step():
            pass
        sim = self.monitor(at=sim_horizon)
        schedule = finalize(self.state, len(self.jobs), float(self.horizon),
                            None, self.queue.default.policy.upper())
        return schedule, sim

    # -- the monitor loop -------------------------------------------------

    @obs.spanned("daemon.monitor")
    def monitor(self, at: "int | None" = None) -> SimResult:
        """Execute the committed assignment in virtual time up to ``at``
        (default: the clock's now) and fold completions back: RUNNING jobs
        whose simulated finish lands within the window advance to DONE
        (journaled), and with ``feedback="actual"`` their observed
        finishes are pushed into the placement state's incremental
        engines via :meth:`~repro_torch.core.api.PlacementState.observe_finish`."""
        limit = int(at if at is not None else self.clock.now())
        key = (self._mutations, limit)
        if self._sim_cache is not None and self._sim_cache[0] == key:
            sim = self._sim_cache[1]
        else:
            sim = simulate(self.cluster, self.jobs, self.state.assignment,
                           horizon=limit,
                           arrivals=np.asarray(self.arrivals, dtype=np.int64)
                           if self.jobs else None,
                           quotas=np.asarray(self.state.seg_quota)
                           if self.state.preempted else None)
            self._sim_cache = (key, sim)
        for record in self.records.values():
            if record.state is not JobState.RUNNING:
                continue
            finish = int(sim.finish[record.jid])
            if finish < 0:
                continue
            record.finish = float(finish)
            self._transition(record, JobState.DONE, finish=finish)
            if self.feedback == "actual":
                self.state.observe_finish(record.job, record.gpus,
                                          float(finish))
        return sim

    # -- crash recovery ---------------------------------------------------

    @classmethod
    def recover(cls, cluster: "Cluster | None", store,
                queue: "QueueManager | None" = None, **kwargs) -> "Daemon":
        """Rebuild a daemon from its journal.

        ``cluster`` may be ``None``: journals opened by this daemon start
        with a ``cluster`` record, from which the exact cluster --
        heterogeneous speed/link arrays included -- is reconstructed.  A
        cluster passed alongside such a journal is cross-checked against
        the record (replaying a journal onto a different cluster would
        silently reprice every placement).

        Replays every entry in sequence order: submissions recreate the
        job records, ``RUNNING`` transitions re-commit the journaled
        ``(gpus, rho, start)`` into a fresh placement state (same float
        operands, same order -- the recovered U/R clocks are bit-identical
        to the crashed daemon's), and jobs whose last word is ``QUEUED``
        or ``PLACING`` are re-enqueued (the latter via a journaled
        recovery transition).  Stateful choosers (RAND's rng) restore the
        generator state snapshotted in each outcome transition, so a job
        caught mid-``PLACING`` is re-decided from exactly the pre-decision
        rng state -- recovery is decision-for-decision exact for every
        registered policy, stochastic ones included.

        A compacted journal (see
        :func:`repro_torch.service.store.compact_entries`) starts with a
        ``snapshot`` record; :meth:`_load_snapshot` rebuilds the folded
        prefix's records and clocks bit-identically, then the tail
        replays through the same bracket-buffered loop as ever.

        ``kwargs`` (``device`` included) go to the constructor, so the
        recovered daemon prices its decisions where a fresh one would."""
        entries = store.entries()
        journaled = None
        if entries and entries[0].kind == "cluster":
            journaled = Cluster.from_payload(entries[0].payload)
        if cluster is None:
            if journaled is None:
                raise ValueError(
                    "journal has no cluster record (pre-heterogeneity "
                    "journal); pass the cluster explicitly")
            cluster = journaled
        daemon = cls(cluster, store, queue, **kwargs)
        # A chooser decision is journaled as a PLACING..decided bracket
        # (possibly containing evict/resize records, the victim's
        # re-placement, and the arrival's own RUNNING mid-bracket -- the
        # preempting arrival commits BEFORE the residual).  Replay
        # buffers each bracket and applies it only when its closing
        # ``decided`` record is present: a journal truncated mid-decision
        # leaves the state exactly pre-decision (victim still RUNNING on
        # its original placement), the job re-enqueues as QUEUED, and the
        # deterministic chooser re-derives the identical decision.
        buf: "tuple[int, list] | None" = None
        for entry in entries:
            if buf is not None:
                jid0, pending = buf
                # Entries a live bracket can never contain mark the open
                # one as abandoned (a crash cut it short and a recovered
                # daemon wrote on): a new round's advance, a submission,
                # a monitor completion, or the same job PLACING again.
                # Its pending entries were never applied pre-crash either,
                # so dropping them reproduces that daemon's state.
                abandoned = entry.kind in ("advance", "submit") or (
                    entry.kind == "transition"
                    and (entry.payload["to"] == JobState.DONE.value
                         or (entry.jid == jid0 and entry.payload["to"]
                             == JobState.PLACING.value)))
                if not abandoned:
                    pending.append(entry)
                    if entry.kind == "decided" and entry.jid == jid0:
                        for buffered in pending:
                            daemon._replay(buffered)
                        buf = None
                    continue
                buf = None          # fall through: replay `entry` normally
            if entry.kind == "transition" and \
                    entry.payload["to"] == JobState.PLACING.value:
                buf = (entry.jid, [entry])
                continue
            daemon._replay(entry)
        requeue = [r for r in daemon.records.values()
                   if r.state in (JobState.QUEUED, JobState.PLACING,
                                  JobState.PENDING)]
        for record in sorted(requeue, key=lambda r: r.jid):
            if record.state is not JobState.QUEUED:
                daemon._transition(record, JobState.QUEUED)
            daemon.queue.push(record)
        return daemon

    def _replay(self, entry) -> None:
        """Fold one journal entry back into records / state / clock."""
        if entry.kind == "cluster":
            if Cluster.from_payload(entry.payload) != self.cluster:
                raise ValueError(
                    "journal cluster record disagrees with the daemon's "
                    "cluster; replay the journal onto the journaled cluster")
            return
        if entry.kind == "snapshot":
            self._load_snapshot(entry.payload)
            return
        if entry.kind == "submit":
            if entry.jid != len(self.jobs):
                raise ValueError(
                    f"journal gap: submit jid {entry.jid} != next jid "
                    f"{len(self.jobs)}")
            job = Job(**entry.payload["job"])
            self.jobs.append(job)
            self.arrivals.append(int(entry.payload["arrival"]))
            self.records[entry.jid] = JobRecord(
                jid=entry.jid, tenant=entry.payload["tenant"], job=job,
                arrival=int(entry.payload["arrival"]))
        elif entry.kind == "advance":
            self.rounds += 1
            self.clock.advance(entry.payload["t"])
        elif entry.kind == "transition":
            record = self.records[entry.jid]
            to = JobState(entry.payload["to"])
            record.advance(to)
            if to is JobState.PLACING:
                # The live daemon advanced the real-time clocks right
                # after journaling PLACING; replay does too (idempotent
                # if the job is later re-placed: advance_to is a max).
                self.state.advance_to(record.arrival)
            elif to is JobState.RUNNING:
                gpus = np.asarray(entry.payload["gpus"], dtype=np.int64)
                rho = float(entry.payload["rho"])
                start = float(entry.payload["start"])
                self.state.advance_to(record.arrival)
                self.state.commit(record.job, gpus, rho, start, self.u)
                record.gpus, record.rho, record.start = gpus, rho, start
            elif to is JobState.DONE:
                record.finish = float(entry.payload["finish"])
                if self.feedback == "actual":
                    self.state.observe_finish(record.job, record.gpus,
                                              record.finish)
            snapshot = entry.payload.get("rng")
            if snapshot is not None:
                self._chooser_for(record.tenant).set_state(snapshot)
        elif entry.kind in ("evict", "resize"):
            # Re-run the checkpoint-restart surgery with the journaled
            # operands; evict() is float-exact over the committed state,
            # so the replayed residual must equal the journaled one
            # bit-for-bit (anything else means the journal diverged from
            # the placements replayed so far).
            record = self.records[entry.jid]
            residual = apply_evict(self.state, entry.jid,
                                   float(entry.payload["t"]), self.u,
                                   num_gpus=int(entry.payload["num_gpus"]))
            if residual is None or \
                    residual.iters != float(entry.payload["iters"]):
                raise ValueError(
                    f"journal divergence replaying {entry.kind} of job "
                    f"{entry.jid}: residual iters "
                    f"{None if residual is None else residual.iters} != "
                    f"journaled {entry.payload['iters']}")
            record.job = residual
        elif entry.kind == "decided":
            pass    # pure bracket delimiter; the entries it closed did the work
        else:
            raise ValueError(f"unknown journal entry kind {entry.kind!r}")

    def _load_snapshot(self, payload: dict) -> None:
        """Rebuild records and placement state from a compacted journal
        prefix (:func:`repro_torch.service.store.compact_entries`).

        The ops stream replays the exact placement-state mutations the
        folded entries would have replayed -- same float operands, same
        order -- so the rebuilt U/R clocks are bit-identical to a full
        replay of the uncompacted journal.  Lifecycle states are assigned
        directly (the snapshot was folded from a journal that already
        passed :meth:`JobRecord.advance` validation entry by entry)."""
        if self.jobs:
            raise ValueError("snapshot record must precede all submissions")
        for jid, jp in enumerate(payload["jobs"]):
            job = Job(**jp["job"])
            self.jobs.append(job)
            self.arrivals.append(int(jp["arrival"]))
            self.records[jid] = JobRecord(jid=jid, tenant=jp["tenant"],
                                          job=job, arrival=int(jp["arrival"]))
        for op in payload["ops"]:
            kind = op["op"]
            if kind == "adv":
                self.state.advance_to(float(op["t"]))
            elif kind == "commit":
                record = self.records[op["jid"]]
                gpus = np.asarray(op["gpus"], dtype=np.int64)
                rho, start = float(op["rho"]), float(op["start"])
                self.state.advance_to(record.arrival)
                self.state.commit(record.job, gpus, rho, start, self.u)
                record.gpus, record.rho, record.start = gpus, rho, start
            elif kind in ("evict", "resize"):
                record = self.records[op["jid"]]
                residual = apply_evict(self.state, op["jid"],
                                       float(op["t"]), self.u,
                                       num_gpus=int(op["num_gpus"]))
                if residual is None or \
                        residual.iters != float(op["iters"]):
                    raise ValueError(
                        f"snapshot divergence replaying {kind} of job "
                        f"{op['jid']}: residual iters "
                        f"{None if residual is None else residual.iters} "
                        f"!= snapshotted {op['iters']}")
                record.job = residual
                record.gpus = record.rho = record.start = None
            elif kind == "done":
                record = self.records[op["jid"]]
                record.finish = float(op["finish"])
                if self.feedback == "actual":
                    self.state.observe_finish(record.job, record.gpus,
                                              record.finish)
            else:
                raise ValueError(f"unknown snapshot op kind {kind!r}")
        for jid, jp in enumerate(payload["jobs"]):
            record = self.records[jid]
            record.state = JobState(jp["state"])
            if record.state in (JobState.PENDING, JobState.QUEUED):
                record.gpus = record.rho = record.start = None
        self.rounds = int(payload["rounds"])
        self.clock.advance(float(payload["t"]))
        for tenant, snap in payload["rng"].items():
            self._chooser_for(tenant).set_state(snap)

    # -- internals --------------------------------------------------------

    def _pricing(self):
        """The tau backend of one chooser run: the kernel on a CUDA
        device (entered per decision: the switch is module-wide), the
        module's own setting on the CPU."""
        if self.device.type == "cuda":
            return tau_backend("kernel", self.device)
        return contextlib.nullcontext()

    def _capture_commit(self, job, gpus, rho, start) -> None:
        """PlacementState.commit_hook: capture the exact committed floats
        (journaling est_finish - est_start would not round-trip rho)."""
        self._mutations += 1
        self._events.append(("commit", job.jid, np.asarray(gpus),
                             float(rho), float(start)))

    def _capture_evict(self, job, t_ev, residual) -> None:
        """PlacementState.evict_hook: capture a preemption so step() can
        journal it (an ``evict``/``resize`` record plus the victim's
        RUNNING -> QUEUED transition) inside the decision bracket."""
        self._mutations += 1
        self._events.append(("evict", job, float(t_ev), residual))

    def _chooser_for(self, tenant: str):
        """The tenant's online chooser (built once per tenant via the
        core chooser registry)."""
        if tenant not in self._choosers:
            cfg = self.queue.config_for(tenant)
            factory = get_chooser(cfg.policy)
            self._choosers[tenant] = factory(self.cluster, self.u,
                                             cfg.param_dict())
        return self._choosers[tenant]

    def _transition(self, record: JobRecord, to: JobState,
                    **payload) -> None:
        """Validate, apply, then journal one lifecycle transition."""
        record.advance(to)
        self.store.append("transition", record.jid,
                          {"to": to.value, **payload}, ts=self.clock.now())

    @property
    def active(self) -> int:
        """Jobs not yet in a terminal state."""
        return sum(1 for r in self.records.values()
                   if r.state not in TERMINAL)
