"""Explicit job state machine of the scheduler service.

Every job a :class:`~repro_torch.service.api.SchedulerService` accepts walks a
validated lifecycle::

    PENDING -> QUEUED -> PLACING -> RUNNING -> DONE
       |          ^         |        |  \\-> FAILED
       |          |         +-> FAILED (no feasible placement)
       |          |         +-> QUEUED (crash recovery re-enqueue)
       |          +-----------------/   (preemption: evicted mid-run)
       \\-> CANCELLED (cancel only before placement)

``PENDING`` is the instant between journaling a submission and admitting
it to the queue manager; ``PLACING`` brackets exactly the window in which
the daemon runs the policy chooser, so a journal whose last word on a job
is ``PLACING`` identifies work lost to a crash (recovery re-enqueues it
and the deterministic chooser re-derives the same placement).  Under the
paper's non-preemptive Eq. (3) setting ``RUNNING`` jobs are only observed
to ``DONE`` by the monitor loop; the preemptive policy family
(:mod:`repro_torch.core.preempt`) adds ``RUNNING -> QUEUED``: an evicted job
re-enters the queue as its residual (checkpointed) remainder, journaled
as an ``evict``/``resize`` record so recovery replays the preemption
exactly.

Transitions not in :data:`TRANSITIONS` raise :class:`InvalidTransition`;
both the live daemon and journal replay go through
:meth:`JobRecord.advance`, so a corrupt or hand-edited journal fails loud
instead of reconstructing an impossible state.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.core.jobs import Job

__all__ = ["JobState", "TRANSITIONS", "TERMINAL", "InvalidTransition",
           "JobRecord"]


class JobState(str, enum.Enum):
    """Lifecycle states of a service-managed job."""

    PENDING = "PENDING"        # journaled, not yet admitted to the queue
    QUEUED = "QUEUED"          # waiting for a scheduling round
    PLACING = "PLACING"        # the chooser is deciding (crash window)
    RUNNING = "RUNNING"        # placement committed, executing
    DONE = "DONE"              # observed complete by the monitor
    CANCELLED = "CANCELLED"    # withdrawn before placement
    FAILED = "FAILED"          # no feasible placement within the budget


#: Validated transition relation; ``PLACING -> QUEUED`` is the crash
#: recovery re-enqueue and ``RUNNING -> QUEUED`` the preemptive eviction
#: (repro_torch.core.preempt), everything else is the normal lifecycle.
TRANSITIONS: dict[JobState, frozenset[JobState]] = {
    JobState.PENDING: frozenset({JobState.QUEUED, JobState.CANCELLED}),
    JobState.QUEUED: frozenset({JobState.PLACING, JobState.CANCELLED}),
    JobState.PLACING: frozenset({JobState.RUNNING, JobState.FAILED,
                                 JobState.QUEUED}),
    JobState.RUNNING: frozenset({JobState.DONE, JobState.FAILED,
                                 JobState.QUEUED}),
    JobState.DONE: frozenset(),
    JobState.CANCELLED: frozenset(),
    JobState.FAILED: frozenset(),
}

#: States with no outgoing transitions.
TERMINAL: frozenset[JobState] = frozenset(
    s for s, outs in TRANSITIONS.items() if not outs)


class InvalidTransition(ValueError):
    """Raised on a lifecycle move outside :data:`TRANSITIONS`."""


@dataclasses.dataclass
class JobRecord:
    """One job's service-side record: identity, lifecycle, placement.

    ``rho`` and ``start`` keep the *exact* floats the placement was
    committed with (see :meth:`repro_torch.core.api.PlacementState.commit`);
    journal replay re-commits them bit-for-bit, which is what makes a
    recovered daemon's busy-time clocks identical to the pre-crash ones.
    """

    jid: int
    tenant: str
    job: Job
    arrival: int
    state: JobState = JobState.PENDING
    gpus: np.ndarray | None = None     # placement (RUNNING and later)
    rho: float | None = None           # committed rho_hat(y^k) charge
    start: float | None = None         # committed est. gang start
    finish: float | None = None        # observed (simulated) finish

    def advance(self, to: JobState) -> None:
        """Validated transition; raises :class:`InvalidTransition`."""
        if to not in TRANSITIONS[self.state]:
            raise InvalidTransition(
                f"job {self.jid}: {self.state.value} -> {to.value} is not "
                f"a legal transition (allowed: "
                f"{sorted(s.value for s in TRANSITIONS[self.state])})")
        self.state = to
        if to is JobState.QUEUED:      # (re-)enqueued: placement is void
            self.gpus = None
            self.rho = None
            self.start = None
