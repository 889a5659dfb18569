"""Queue manager: batches pending arrivals into scheduling rounds.

Queued jobs are held in a min-heap keyed ``(arrival, G_j, jid)`` -- the
visit order of :func:`repro_torch.core.api.schedule_arrivals` -- so however the
daemon slices rounds (one arrival slot at a time, wider windows via
``round_slots``, or hard caps via ``max_batch``), the concatenation of all
rounds processes jobs in exactly the order the one-shot epoch loop would.
That invariant is what makes the daemon path result-identical to a direct
``schedule_arrivals`` call (held by ``tests/test_torch_service.py``).

Per-tenant scheduling configuration lives here too: each tenant maps to a
:class:`TenantConfig` naming a registered policy and its params; the
daemon resolves the tenant's online chooser through
:func:`repro_torch.core.api.get_chooser` -- the same registry every policy's own
``arrivals`` branch uses.
"""
from __future__ import annotations

import dataclasses
import heapq

from repro_torch.service.state import JobRecord

__all__ = ["TenantConfig", "QueueManager"]


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's scheduling knobs: a registered policy name plus the
    ``params`` its chooser factory understands (``seed`` for RAND, ...;
    the contention ``engine`` is daemon-wide, since all tenants share one
    :class:`~repro_torch.core.api.PlacementState`)."""

    policy: str = "sjf-bco"
    params: tuple[tuple[str, object], ...] = ()

    def param_dict(self) -> dict:
        """``params`` as the dict the chooser factories expect."""
        return dict(self.params)


class QueueManager:
    """Pending-arrival queue + per-tenant config.

    ``round_slots`` bounds how many distinct arrival slots one round may
    span (default 1: a round is one arrival slot's batch); ``max_batch``
    caps the round size in jobs.  Neither affects the processing order,
    only how much work each :meth:`next_batch` hands the daemon."""

    def __init__(self, default: TenantConfig | None = None,
                 tenants: "dict[str, TenantConfig] | None" = None,
                 round_slots: int = 1,
                 max_batch: "int | None" = None):
        self.default = default or TenantConfig()
        self.tenants = dict(tenants or {})
        if round_slots < 1:
            raise ValueError("round_slots must be >= 1")
        self.round_slots = round_slots
        self.max_batch = max_batch
        self._heap: list[tuple[int, int, int]] = []   # (arrival, G, jid)
        self._records: dict[int, JobRecord] = {}
        self._cancelled: set[int] = set()

    def config_for(self, tenant: str) -> TenantConfig:
        """The tenant's config (the default for unknown tenants)."""
        return self.tenants.get(tenant, self.default)

    def push(self, record: JobRecord) -> None:
        """Enqueue a QUEUED record for a future scheduling round."""
        self._records[record.jid] = record
        self._cancelled.discard(record.jid)
        heapq.heappush(self._heap,
                       (record.arrival, record.job.num_gpus, record.jid))

    def cancel(self, jid: int) -> bool:
        """Lazily drop ``jid`` from the queue; True if it was queued."""
        if jid not in self._records or jid in self._cancelled:
            return False
        self._cancelled.add(jid)
        return True

    def __len__(self) -> int:
        return len(self._records) - len(self._cancelled)

    def peek_arrival(self) -> "int | None":
        """Arrival slot of the earliest queued job, or None if empty."""
        self._drop_cancelled()
        return self._heap[0][0] if self._heap else None

    def _drop_cancelled(self) -> None:
        while self._heap and self._heap[0][2] in self._cancelled:
            jid = heapq.heappop(self._heap)[2]
            self._cancelled.discard(jid)
            del self._records[jid]

    def next_batch(self) -> list[JobRecord]:
        """Pop the next scheduling round, in ``(arrival, G_j, jid)`` order.

        The round covers queued jobs whose arrival slot falls within
        ``round_slots`` slots of the earliest pending arrival, capped at
        ``max_batch`` jobs; empty list when nothing is queued."""
        self._drop_cancelled()
        if not self._heap:
            return []
        cutoff = self._heap[0][0] + self.round_slots
        batch: list[JobRecord] = []
        while self._heap and self._heap[0][0] < cutoff:
            if self.max_batch is not None and len(batch) >= self.max_batch:
                break
            _, _, jid = heapq.heappop(self._heap)
            batch.append(self._records.pop(jid))
            self._drop_cancelled()
        return batch
