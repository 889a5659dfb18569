"""Write-ahead journal stores for the scheduler daemon.

The daemon journals every externally-visible step -- submissions, state
transitions (with the exact placement floats), virtual-clock advances --
as an append-only sequence of :class:`JournalEntry` records.  Recovery is
pure replay: :meth:`repro_torch.service.daemon.Daemon.recover` folds the journal
back into job records and re-commits journaled placements into a fresh
:class:`~repro_torch.core.api.PlacementState` in journal order, which reproduces
the busy-time clocks bit-for-bit (same float operands, same order).

Two backends share the interface:

  * :class:`MemoryStore` -- a list; for tests (its :meth:`MemoryStore.prefix`
    powers the fault-injection loop that crashes the daemon after every
    journaled event) and for benchmarks that isolate scheduling cost.
  * :class:`SqliteStore` -- stdlib ``sqlite3`` in WAL mode, one row per
    entry; survives process death, so a daemon pointed at the same path
    picks up exactly where the last one crashed.

Payload floats (``rho``, ``start``, ``finish``) must round-trip exactly:
JSON via ``repr`` and SQLite ``REAL`` columns both preserve IEEE-754
doubles bit-for-bit.

Both stores also support **snapshot compaction**: a long-running daemon's
journal grows by ~6 entries per job, so :meth:`MemoryStore.snapshot` /
:meth:`SqliteStore.snapshot` fold the longest quiescent prefix (every
closed PLACING..decided bracket) into one ``"snapshot"`` record via
:func:`compact_entries`.  The snapshot keeps exactly what replay needs --
the submitted jobs, final lifecycle states, and the ordered stream of
placement-state mutations with their journaled floats -- so
:meth:`repro_torch.service.daemon.Daemon.recover` over ``cluster + snapshot +
tail`` rebuilds busy-time clocks bit-identical to replaying the
uncompacted journal.
"""
from __future__ import annotations

import dataclasses
import json
import sqlite3

from repro_torch import obs

__all__ = ["JournalEntry", "MemoryStore", "SqliteStore", "compact_entries",
           "open_store"]


@dataclasses.dataclass(frozen=True)
class JournalEntry:
    """One journaled event.

    ``kind`` is ``"cluster"`` (entry 1 of every fresh journal: the
    :meth:`~repro_torch.core.cluster.Cluster.to_payload` description, so
    recovery can rebuild heterogeneous clusters without out-of-band
    state), ``"submit"`` (payload: tenant, arrival, job fields),
    ``"transition"`` (payload: ``to`` state plus, for RUNNING, the exact
    ``gpus``/``rho``/``start``; for DONE, ``finish``; for outcomes of a
    stateful chooser, its post-decision ``rng`` generator state),
    ``"advance"`` (payload: the virtual-clock slot ``t`` of a round),
    ``"decided"`` (empty payload: closes a chooser decision's
    PLACING..decided bracket, making its replay all-or-nothing), or a
    preemption record -- ``"evict"`` / ``"resize"`` (payload: the exact
    eviction instant ``t`` plus the residual's ``iters``/``num_gpus``;
    see :mod:`repro_torch.core.preempt`) -- journaled inside the preempting
    arrival's decision bracket.  A compacted journal additionally holds
    one ``"snapshot"`` entry right after the cluster record: the folded
    prefix produced by :func:`compact_entries`."""

    seq: int
    ts: float                  # virtual-clock stamp (deterministic tests)
    kind: str
    jid: int                   # -1 for job-less entries (advance)
    payload: dict

    def to_json(self) -> str:
        """Payload as canonical JSON (floats via repr: exact round-trip)."""
        return json.dumps(self.payload, sort_keys=True)


def compact_entries(entries: "list[JournalEntry]"
                    ) -> "tuple[list[JournalEntry], list[JournalEntry]] | None":
    """Fold the longest quiescent journal prefix into one snapshot record.

    Returns ``(folded, tail)`` where ``folded`` is ``[cluster_entry,
    snapshot_entry]`` and ``tail`` is the unfolded suffix (entries inside
    a still-open PLACING..decided bracket, which replay must see verbatim
    to apply-or-drop atomically), or ``None`` when there is nothing to
    fold.  The walk mirrors :meth:`repro_torch.service.daemon.Daemon.recover`
    exactly: brackets fold only once their closing ``decided`` record is
    present, and an abandoned bracket's entries are dropped (recovery
    drops them too, so the compacted journal replays to the same state).

    The snapshot payload is what replay needs and nothing more:

    * ``jobs`` -- every submission in jid order (tenant, arrival, the
      *original* job fields) plus its final lifecycle state;
    * ``ops`` -- the ordered placement-state mutations: ``adv`` (the
      real-time clock advance journaled by each PLACING), ``commit``
      (the exact ``gpus``/``rho``/``start`` floats -- U += charges are
      float-order-sensitive, so order is preserved), ``evict``/``resize``
      (replayed through :func:`repro_torch.core.preempt.evict`, residual
      cross-checked), and ``done`` (observed finishes, replayed into the
      engines under ``feedback="actual"``);
    * ``rounds`` / ``t`` -- the round counter and final virtual-clock
      slot the dropped ``advance`` entries had accumulated;
    * ``rng`` -- each tenant's last journaled chooser generator state.

    A prefix that already starts with a snapshot is re-folded: the old
    snapshot seeds the walk, so compaction composes.
    """
    if len(entries) < 2 or entries[0].kind != "cluster":
        return None
    jobs: list[dict] = []
    ops: list[dict] = []
    rounds, t = 0, 0.0
    rng: dict = {}
    start = 1
    if entries[1].kind == "snapshot":
        prev = entries[1].payload
        jobs = [dict(j) for j in prev["jobs"]]
        ops = list(prev["ops"])
        rounds, t = int(prev["rounds"]), float(prev["t"])
        rng = dict(prev["rng"])
        start = 2

    def fold(entry: JournalEntry) -> None:
        nonlocal rounds, t
        if entry.kind == "submit":
            if entry.jid != len(jobs):
                raise ValueError(f"journal gap: submit jid {entry.jid} != "
                                 f"next jid {len(jobs)}")
            jobs.append({"tenant": entry.payload["tenant"],
                         "arrival": int(entry.payload["arrival"]),
                         "job": entry.payload["job"], "state": "PENDING"})
        elif entry.kind == "advance":
            rounds += 1
            t = max(t, float(entry.payload["t"]))
        elif entry.kind == "transition":
            rec = jobs[entry.jid]
            to = entry.payload["to"]
            rec["state"] = to
            if to == "PLACING":
                ops.append({"op": "adv", "t": float(rec["arrival"])})
            elif to == "RUNNING":
                ops.append({"op": "commit", "jid": entry.jid,
                            "gpus": entry.payload["gpus"],
                            "rho": entry.payload["rho"],
                            "start": entry.payload["start"]})
            elif to == "DONE":
                rec["finish"] = entry.payload["finish"]
                ops.append({"op": "done", "jid": entry.jid,
                            "finish": entry.payload["finish"]})
            if "rng" in entry.payload:
                rng[rec["tenant"]] = entry.payload["rng"]
        elif entry.kind in ("evict", "resize"):
            ops.append({"op": entry.kind, "jid": entry.jid,
                        "t": entry.payload["t"],
                        "iters": entry.payload["iters"],
                        "num_gpus": entry.payload["num_gpus"]})
        elif entry.kind != "decided":      # decided: pure bracket delimiter
            raise ValueError(
                f"cannot fold journal entry kind {entry.kind!r}")

    safe = start                # index just past the last folded entry
    buf: "tuple[int, list] | None" = None
    i = start
    while i < len(entries):
        entry = entries[i]
        if buf is not None:
            jid0, pending = buf
            abandoned = entry.kind in ("advance", "submit") or (
                entry.kind == "transition"
                and (entry.payload["to"] == "DONE"
                     or (entry.jid == jid0
                         and entry.payload["to"] == "PLACING")))
            if not abandoned:
                pending.append(entry)
                if entry.kind == "decided" and entry.jid == jid0:
                    for buffered in pending:
                        fold(buffered)
                    buf = None
                    safe = i + 1
                i += 1
                continue
            buf = None          # fall through: fold `entry` normally
        if entry.kind == "transition" and \
                entry.payload["to"] == "PLACING":
            buf = (entry.jid, [entry])
            i += 1
            continue
        fold(entry)
        safe = i + 1
        i += 1
    if safe <= start:
        return None
    last = entries[safe - 1]
    snap = JournalEntry(seq=last.seq, ts=last.ts, kind="snapshot", jid=-1,
                        payload={"jobs": jobs, "ops": ops, "rounds": rounds,
                                 "t": t, "rng": rng})
    return [entries[0], snap], entries[safe:]


class MemoryStore:
    """In-memory journal: a list of entries, no durability."""

    def __init__(self, entries: "list[JournalEntry] | None" = None):
        self._entries: list[JournalEntry] = list(entries or [])
        # Sequence numbers survive compaction (a snapshot replaces many
        # entries by one), so the counter is persistent, not len+1.
        self._next_seq = self._entries[-1].seq + 1 if self._entries else 1

    @obs.spanned("journal.append")
    def append(self, kind: str, jid: int, payload: dict,
               ts: float = 0.0) -> JournalEntry:
        """Append one entry; returns it with its assigned sequence number."""
        entry = JournalEntry(seq=self._next_seq, ts=ts, kind=kind,
                             jid=jid, payload=payload)
        self._next_seq += 1
        self._entries.append(entry)
        return entry

    def entries(self) -> list[JournalEntry]:
        """The whole journal, in append order."""
        return list(self._entries)

    def prefix(self, n: int) -> "MemoryStore":
        """A copy holding only the first ``n`` entries -- a simulated
        crash snapshot for the fault-injection recovery tests."""
        return MemoryStore(self._entries[:n])

    def snapshot(self) -> int:
        """Compact via :func:`compact_entries`; returns entries saved."""
        folded = compact_entries(self._entries)
        if folded is None:
            return 0
        kept, tail = folded
        saved = len(self._entries) - len(kept) - len(tail)
        self._entries = kept + tail
        return saved

    def __len__(self) -> int:
        return len(self._entries)

    def close(self) -> None:
        """No-op (symmetry with :class:`SqliteStore`)."""


class SqliteStore:
    """Durable journal on stdlib ``sqlite3``.

    WAL journaling keeps appends atomic under crashes; each ``append``
    commits, so an entry either exists completely or not at all -- the
    property the recovery replay relies on."""

    def __init__(self, path: str):
        self.path = path
        self._db = sqlite3.connect(path)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS journal ("
            " seq INTEGER PRIMARY KEY AUTOINCREMENT,"
            " ts REAL NOT NULL,"
            " kind TEXT NOT NULL,"
            " jid INTEGER NOT NULL,"
            " payload TEXT NOT NULL)")
        self._db.commit()

    @obs.spanned("journal.append")
    def append(self, kind: str, jid: int, payload: dict,
               ts: float = 0.0) -> JournalEntry:
        """Append + commit one entry; returns it with its sequence number."""
        cur = self._db.execute(
            "INSERT INTO journal (ts, kind, jid, payload) VALUES (?,?,?,?)",
            (ts, kind, jid, json.dumps(payload, sort_keys=True)))
        self._db.commit()
        return JournalEntry(seq=cur.lastrowid, ts=ts, kind=kind, jid=jid,
                            payload=payload)

    def entries(self) -> list[JournalEntry]:
        """The whole journal, in sequence order."""
        rows = self._db.execute(
            "SELECT seq, ts, kind, jid, payload FROM journal ORDER BY seq")
        return [JournalEntry(seq=s, ts=ts, kind=k, jid=j,
                             payload=json.loads(p))
                for s, ts, k, j, p in rows]

    def snapshot(self) -> int:
        """Compact via :func:`compact_entries`; returns rows saved.

        The folded rows are replaced by one ``snapshot`` row carrying the
        last folded sequence number, in a single transaction; AUTOINCREMENT
        keeps later appends above every seq ever issued, so compaction
        never reuses a sequence number."""
        entries = self.entries()
        folded = compact_entries(entries)
        if folded is None:
            return 0
        (cluster, snap), tail = folded
        self._db.execute("DELETE FROM journal WHERE seq > ? AND seq <= ?",
                         (cluster.seq, snap.seq))
        self._db.execute(
            "INSERT INTO journal (seq, ts, kind, jid, payload) "
            "VALUES (?,?,?,?,?)",
            (snap.seq, snap.ts, snap.kind, snap.jid,
             json.dumps(snap.payload, sort_keys=True)))
        self._db.commit()
        return len(entries) - 2 - len(tail)

    def __len__(self) -> int:
        return int(self._db.execute(
            "SELECT COUNT(*) FROM journal").fetchone()[0])

    def close(self) -> None:
        """Close the connection (flushes the WAL)."""
        self._db.close()


def open_store(path: "str | None" = None):
    """``None`` -> :class:`MemoryStore`, else :class:`SqliteStore` at path."""
    return MemoryStore() if path is None else SqliteStore(path)
