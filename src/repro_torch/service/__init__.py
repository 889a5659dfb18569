"""repro_torch.service: the port's long-running scheduler daemon over the
paper's online path, with a validated job lifecycle, a write-ahead journal
(in-memory or stdlib sqlite) and crash recovery by replay.

The service adds *operability*, not new scheduling semantics: every
placement decision flows through the same chooser registry and
:class:`~repro_torch.core.api.PlacementState` that
:func:`repro_torch.core.api.schedule_arrivals` uses, so a drained service
reproduces the one-shot online schedule decision-for-decision (held by
``tests/test_torch_service.py`` and, on the card, ``chip_smoke.py``).
Start with :class:`~repro_torch.service.api.SchedulerService`.
"""
from repro_torch.service.api import (JobHandle, JobStatus, SchedulerService,
                                     SubmitRequest)
from repro_torch.service.daemon import Daemon, VirtualClock
from repro_torch.service.queue import QueueManager, TenantConfig
from repro_torch.service.state import (TERMINAL, TRANSITIONS,
                                       InvalidTransition, JobRecord, JobState)
from repro_torch.service.store import (JournalEntry, MemoryStore, SqliteStore,
                                       compact_entries, open_store)

__all__ = [
    "SchedulerService", "SubmitRequest", "JobHandle", "JobStatus",
    "Daemon", "VirtualClock",
    "QueueManager", "TenantConfig",
    "JobState", "JobRecord", "TRANSITIONS", "TERMINAL", "InvalidTransition",
    "JournalEntry", "MemoryStore", "SqliteStore", "compact_entries",
    "open_store",
]
