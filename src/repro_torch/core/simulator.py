"""Discrete-time execution engine for RAR-DDLS schedules.

The paper's Fig. 3 loop needs the *actual* execution time rho(y) of a
schedule, which has no closed form because contention (Eq. 6) depends on the
time-varying set of concurrently active jobs.  This simulator evaluates it:

  * a schedule is an ordered assignment [(job, gpu_ids), ...];
  * each GPU serves its assigned entries FIFO in schedule order;
  * an entry starts (gang-scheduled, Eqs. 1-5) when it reaches the head of
    *all* its GPUs' queues;
  * while active, it progresses phi_j[t] = floor(1/tau_j[t]) iterations per
    slot, with tau recomputed from Eq. (8) every time the active set changes;
  * it completes once its iteration quota is accumulated (Eq. 9) and
    releases its GPUs simultaneously.

In the paper's non-preemptive Eq. (3) setting every job is exactly one
assignment entry with quota F_j.  Preemptive schedules
(:mod:`repro_torch.core.preempt`) may list a job id several times -- its
checkpointed SEGMENTS, each carrying an iteration quota (the
``quotas`` argument, produced by ``ScheduleResult.quotas``); segments of
one job execute in assignment order (a segment cannot start before its
predecessor completes -- the checkpoint-restart dependency), may sit on
different GPU sets (migration) and even different worker counts (elastic
resize; the contention terms use the segment's width).  The job starts
at its first segment's start and finishes at its last segment's finish.
All internal bookkeeping is keyed by assignment entry; for
single-segment schedules (quotas=None) every ordering tie-break reduces
to the job-id FIFO order of earlier releases, so results are
bit-identical to the non-preemptive engine.

Event-driven between active-set changes (contention is piecewise constant),
so the engine is exact w.r.t. the slot model but runs in O(events).  Under
the default ``"incremental"`` engine the Eq. (6)-(8) terms are maintained
by an :class:`~repro_torch.core.contention.IncrementalEval` across windows --
each start/finish is one O(S + affected) row update instead of a full
[J, S] re-evaluation -- with bit-identical results to the ``"reference"``
per-window :func:`~repro_torch.core.contention.evaluate`.

Readiness tracking (which queued entries may start at an event boundary)
also has two bit-identical modes, selected with ``readiness``:

  * ``"tracked"`` (default) -- incremental: per-GPU queue-head pointers and
    a per-entry "GPUs-at-head" counter, updated only when an entry finishes
    (O(G) per completion), plus arrival-sorted heaps.  Each event touches
    only the entries it affects.  Segment precedence enters as one extra
    gate: an entry whose GPUs are all at head but whose predecessor segment
    is unfinished parks until that completion re-checks it.
  * ``"rescan"`` -- the reference O(E * G) per-event rescan of every
    scheduled entry against every queue head, kept as the semantics oracle
    (``tests/test_simulator_equivalence.py`` pins event-for-event
    equality).

Both modes start ready entries in sorted (job id, segment) order (the
FIFO tie-break), so the SimEvent stream, start/finish arrays and all
derived metrics are identical.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch import obs
from repro_torch.core.cluster import Cluster
from repro_torch.core.contention import (IncrementalEval, evaluate, ladder_terms,
                                   resolve_engine, tau_ladder)
from repro_torch.core.jobs import Job

Assignment = list[tuple[int, np.ndarray]]  # (job index, global GPU ids)

READINESS_MODES = ("tracked", "rescan")
STEPPING_MODES = ("multi", "single")

# Cap on how many completion stages ahead a multi-window ladder
# precomputes per stack_model call.  The actual depth ramps adaptively:
# shallow while job starts keep invalidating ladders (each start changes
# every row's contention), doubling whenever a ladder is exhausted by a
# long start-free run of windows.
LADDER_DEPTH = 32


@dataclasses.dataclass(frozen=True)
class SimEvent:
    """One piecewise-constant contention window of the execution.

    Idle windows (the cluster waiting for the next arrival) are recorded
    too, with ``active == 0`` and ``busy_gpus == 0``, so time-weighted
    statistics over the event stream cover the whole run, not just busy
    time."""

    t: int                     # window start (slot)
    dt: int                    # window length (slots)
    active: int                # #concurrently running entries (0 = idle gap)
    contention: int            # max p_j over the active set (Eq. 6)
    busy_gpus: int             # #GPUs occupied during the window


@dataclasses.dataclass
class SimResult:
    start: np.ndarray          # a_j per job (slot), -1 if never started
    finish: np.ndarray         # T_j per job (slot), -1 if never finished
    makespan: float
    avg_jct: float             # mean(finish - arrival) over completed jobs
    avg_queueing_delay: float  # mean(start - arrival) over completed jobs
    completed: int
    horizon_hit: bool
    peak_contention: int       # max p_j[t] observed
    busy_gpu_slots: float      # sum over entries of in-service time * width
    total_gpu_slots: float     # makespan * N

    events: list[SimEvent] = dataclasses.field(default_factory=list)

    @property
    def utilization(self) -> float:
        return self.busy_gpu_slots / max(self.total_gpu_slots, 1e-12)

    @property
    def mean_contention(self) -> float:
        """Time-weighted mean of the per-window max contention level.

        Weighted over the full event stream -- including zero-active idle
        windows -- so the mean reflects wall-clock time, not busy time."""
        total = sum(e.dt for e in self.events)
        if not total:
            return 0.0
        return sum(e.contention * e.dt for e in self.events) / total


@obs.spanned("sim.simulate")
def simulate(cluster: Cluster, jobs: list[Job], assignment: Assignment,
             horizon: int = 10**7,
             arrivals: np.ndarray | None = None,
             engine: str | None = None,
             readiness: str = "tracked",
             stepping: str | None = None,
             quotas: np.ndarray | list | None = None) -> SimResult:
    """Execute ``assignment`` on ``cluster`` and return actual timings.

    ``arrivals[j]`` (optional) forbids starting job j before its arrival
    slot (online scheduling); ``avg_jct`` is then the mean of
    ``finish - arrival`` over completed jobs (with ``arrivals=None``
    every job arrives at slot 0, so it reduces to the mean finish slot).

    ``quotas`` (optional) gives the iteration quota of each assignment
    entry (same length/order as ``assignment``) and unlocks the
    preemptive interpretation: a job id may then appear in several
    entries -- its checkpoint-restart segments, executed in assignment
    order -- and an entry's GPU count may differ from the job's
    requested G_j (elastic resize).  Without it (the default), every
    job must appear exactly once with exactly its requested GPUs and
    its quota is F_j -- the paper's Eq. (3) setting, bit-identical to
    the pre-preemption engine.

    ``engine`` selects the contention-model evaluation strategy:
    ``"reference"`` re-evaluates each window from scratch; anything else
    (``"incremental"``, and ``"batched"`` -- which has no meaning for the
    one-placement-per-window simulator) maintains the active set
    incrementally across windows.  ``readiness`` selects how queue-ready
    entries are discovered (``"tracked"`` incremental counters, the
    default, vs the ``"rescan"`` reference; see the module docstring).

    ``stepping`` selects how window models are produced between active-set
    changes:

      * ``"multi"`` -- speculative multi-window ladders: while the
        tracked-readiness bookkeeping shows no arrivals or queue-head
        promotions, the Eq. (6)-(8) terms for the next ``LADDER_DEPTH``
        completion stages are computed in one vectorised
        :func:`~repro_torch.core.contention.stack_model` batch over a
        [M, A, S] stack with shrinking row masks (guessed completion
        order, verified window by window, rebuilt on mispredict);
      * ``"single"`` -- one model per window (the IncrementalEval /
        reference path of earlier releases);
      * ``None`` (default) -- ``"multi"`` whenever both oracle axes are
        off (tracked readiness, non-reference engine), else ``"single"``.

    Results are identical across engines, readiness and stepping modes
    (pinned by ``tests/test_simulator_equivalence.py``,
    ``tests/test_preempt_equivalence.py`` and
    ``tests/test_bisect_equivalence.py``)."""
    n_jobs = len(jobs)
    incremental = resolve_engine(engine) != "reference"
    if readiness not in READINESS_MODES:
        raise ValueError(
            f"unknown readiness mode {readiness!r}; choose from {READINESS_MODES}")
    tracked = readiness == "tracked"
    if stepping is not None and stepping not in STEPPING_MODES:
        raise ValueError(
            f"unknown stepping mode {stepping!r}; choose from {STEPPING_MODES}")
    if stepping == "multi" and not (tracked and incremental):
        raise ValueError(
            'stepping="multi" needs readiness="tracked" and a non-reference '
            "engine (the rescan/reference combinations are the "
            "event-for-event oracle and step one window at a time)")
    multiwindow = (tracked and incremental) if stepping is None \
        else stepping == "multi"
    if arrivals is not None:
        arrivals = np.asarray(arrivals)
    E = len(assignment)
    if quotas is not None:
        quotas = np.asarray(quotas, dtype=np.float64)
        if quotas.shape != (E,):
            raise ValueError(
                f"quotas shape {quotas.shape} != ({E},): one iteration "
                "quota per assignment entry")

    # ----- entry-keyed schedule bookkeeping --------------------------------
    # ekey = (jid, segment index) orders every tie-break; single-segment
    # schedules make it (jid, 0), i.e. the legacy jid order.
    queues: list[list[int]] = [[] for _ in range(cluster.num_gpus)]
    gpu_sets: list[np.ndarray] = []
    entry_jobs: list[Job] = []
    ent_jid = np.empty(E, dtype=np.int64)
    ent_seg = np.empty(E, dtype=np.int64)
    seg_count: dict[int, int] = {}
    srv_of = cluster.gpu_server
    flat_ent: list[int] = []
    flat_gpu: list[int] = []
    for e, (j, gpus) in enumerate(assignment):
        gpus = np.asarray(gpus, dtype=np.int64)
        if len(gpus) != jobs[j].num_gpus:
            if quotas is None:
                raise ValueError(
                    f"job {j}: got {len(gpus)} GPUs, wants {jobs[j].num_gpus}")
            # Elastic segment: the contention terms use its actual width.
            entry_jobs.append(dataclasses.replace(jobs[j],
                                                  num_gpus=len(gpus)))
        else:
            entry_jobs.append(jobs[j])
        ids = gpus.tolist()
        if len(set(ids)) != len(ids):
            raise ValueError(f"job {j}: duplicate GPUs in assignment")
        gpu_sets.append(gpus)
        ent_jid[e] = j
        ent_seg[e] = seg_count.get(j, 0)
        seg_count[j] = int(ent_seg[e]) + 1
        for g in ids:
            queues[g].append(e)
            flat_ent.append(e)
            flat_gpu.append(g)
    if quotas is None:
        for j, c in seg_count.items():
            if c > 1:
                raise ValueError(
                    f"job {j} appears in {c} assignment entries; "
                    "preemptive (multi-segment) schedules must pass quotas")
    # Segment precedence: pred/succ chains in assignment order.
    pred = np.full(E, -1, dtype=np.int64)
    succ = np.full(E, -1, dtype=np.int64)
    last_entry: dict[int, int] = {}
    for e in range(E):
        j = int(ent_jid[e])
        if j in last_entry:
            pred[e] = last_entry[j]
            succ[last_entry[j]] = e
        last_entry[j] = e
    # All entries' per-server GPU counts in one bincount over
    # (entry, server) pairs -- same integer counts as a per-entry
    # bincount, one C call.
    S = cluster.num_servers
    y_ent = np.bincount(
        np.asarray(flat_ent, dtype=np.int64) * S
        + srv_of[np.asarray(flat_gpu, dtype=np.int64)],
        minlength=E * S).reshape(E, S)

    rem_ent = quotas.copy() if quotas is not None else np.asarray(
        [entry_jobs[e].iters for e in range(E)], dtype=np.float64)
    widths = np.asarray([len(g) for g in gpu_sets], dtype=np.int64)
    e_start = np.full(E, -1, dtype=np.int64)
    e_finish = np.full(E, -1, dtype=np.int64)
    start = np.full(n_jobs, -1, dtype=np.int64)
    finish = np.full(n_jobs, -1, dtype=np.int64)
    ents_sorted = sorted(range(E),
                         key=lambda e: (ent_jid[e], ent_seg[e]))
    active: list[int] = []
    inc = IncrementalEval(cluster) if incremental and not multiwindow else None
    rows: dict[int, int] = {}          # entry -> IncrementalEval row handle
    t = 0
    peak_p = 0
    busy_now = 0                       # GPUs occupied by active entries
    busy_gpu_slots = 0.0
    events: list[SimEvent] = []

    def pred_done(e: int) -> bool:
        p = pred[e]
        return p < 0 or e_finish[p] >= 0

    ladder: dict | None = None           # multi-window stage cache
    model_vals: tuple | None = None      # (p, tau, phi) for `active` order
    if multiwindow:
        # Placement-independent Eq. (6)/(8) terms, computed once per run,
        # per assignment entry; ladder stacks gather rows of them.
        terms = ladder_terms(cluster, entry_jobs, y_ent)
        phi_last = np.ones(E)            # ordering hint for the guess
        ladder_ramp = 2                  # adaptive stage depth (see below)

        def build_ladder(act: list[int]) -> dict:
            """One stack_model batch covering the next LADDER_DEPTH
            completion stages of ``act``: stage s masks out the first s
            entries of the guessed completion order (ascending slots-to-
            finish at current rates, stable on the active order).  The
            guess only selects which stacks exist -- each window's
            completions are computed from the stage values and verified
            against the guess, so a mispredicted order costs one rebuild
            and never changes results."""
            act_arr = np.asarray(act, dtype=np.int64)
            A = len(act)
            keys = np.ceil(rem_ent[act_arr] / phi_last[act_arr])
            order = np.lexsort((np.arange(A), keys))
            ents = [act[i] for i in order]
            depth = min(A - 1, ladder_ramp)
            ent_arr = act_arr[order]
            p, tau, phi = tau_ladder(cluster, terms, ent_arr, depth)
            # "rem" caches `rem_ent` in ladder order so window updates
            # are contiguous slice writes; flushed back on invalidation.
            return {"ents": ents, "ent_arr": ent_arr, "stage": 0,
                    "depth": depth, "p": p, "tau": tau, "phi": phi,
                    "rem": rem_ent[ent_arr]}

        def flush_ladder(lad: dict | None) -> None:
            """Write the ladder-ordered remaining cache back before the
            ladder is dropped (build_ladder reads ``rem_ent``)."""
            if lad is not None:
                rem_ent[lad["ent_arr"]] = lad["rem"]

    def _arrival_of(e: int) -> int:
        return int(arrivals[ent_jid[e]]) if arrivals is not None else 0

    if tracked:
        # Incremental readiness: head pointer per GPU queue, and for each
        # unstarted entry the count of its GPUs where it is at the head.
        # An entry is queue-ready when that count reaches its width, which
        # happens exactly once; if its predecessor segment is unfinished
        # it parks (``head_ready``) until that completion re-checks it,
        # otherwise it waits (if needed) in an arrival-sorted heap until
        # its arrival slot.  Startable entries pop in ascending
        # (jid, segment) order -- the same FIFO tie-break as the rescan
        # reference (and plain jid order for single-segment schedules).
        qpos = [0] * cluster.num_gpus
        at_head = [0] * E
        head_ready = [False] * E     # queue-ready, parked on predecessor
        for q in queues:
            if q:
                at_head[q[0]] += 1
        startable: list[tuple[int, int, int]] = []   # (jid, seg, e) heap
        arrival_wait: list[tuple[int, int, int, int]] = []  # + arrival key
        for e in ents_sorted:
            if at_head[e] == widths[e]:
                if pred_done(e):
                    heapq.heappush(arrival_wait,
                                   (_arrival_of(e), int(ent_jid[e]),
                                    int(ent_seg[e]), e))
                else:
                    head_ready[e] = True
        # All unstarted entries, arrival-sorted, for the idle-gap jump;
        # started entries are discarded lazily.
        pending_heap = [(_arrival_of(e), int(ent_jid[e]), int(ent_seg[e]), e)
                        for e in range(E)]
        heapq.heapify(pending_heap)
        n_unstarted = E

        def ready_jobs(now: int) -> list[int]:
            while arrival_wait and arrival_wait[0][0] <= now:
                _, j, s, e = heapq.heappop(arrival_wait)
                heapq.heappush(startable, (j, s, e))
            out = []
            while startable:
                out.append(heapq.heappop(startable)[2])
            return out

        def _now_head_ready(e2: int) -> None:
            if pred_done(e2):
                heapq.heappush(arrival_wait,
                               (_arrival_of(e2), int(ent_jid[e2]),
                                int(ent_seg[e2]), e2))
            else:
                head_ready[e2] = True

        def release_gpus(e: int) -> None:
            # Advance the head pointer on each freed GPU; the new head
            # entry gains one GPU-at-head (it cannot already be running:
            # it was not at the head of this queue until now).
            for g in gpu_sets[e]:
                gi = int(g)
                qpos[gi] += 1
                q = queues[gi]
                if qpos[gi] < len(q):
                    e2 = q[qpos[gi]]
                    at_head[e2] += 1
                    if at_head[e2] == widths[e2]:
                        _now_head_ready(e2)

        def next_pending_arrival() -> int:
            while pending_heap and e_start[pending_heap[0][3]] >= 0:
                heapq.heappop(pending_heap)
            return pending_heap[0][0]
    else:
        def ready_jobs(now: int) -> list[int]:
            # Iterate in sorted (jid, segment) order so start order --
            # hence FIFO tie-breaks -- depends on the schedule, not on
            # set/hash ordering.
            out = []
            for e in ents_sorted:
                if e_start[e] >= 0:
                    continue
                if arrivals is not None and now < arrivals[ent_jid[e]]:
                    continue
                if not pred_done(e):
                    continue
                if all(queues[int(g)] and queues[int(g)][0] == e
                       for g in gpu_sets[e]):
                    out.append(e)
            return out

        def release_gpus(e: int) -> None:
            for g in gpu_sets[e]:
                queues[int(g)].pop(0)

        def next_pending_arrival() -> int:
            return min(_arrival_of(e) for e in range(E) if e_start[e] < 0)

    while t < horizon:
        if tracked and not startable \
                and not (arrival_wait and arrival_wait[0][0] <= t):
            starters = ()        # fast path: provably nothing to start
        else:
            starters = ready_jobs(t)
        for e in starters:
            e_start[e] = t
            j = int(ent_jid[e])
            if start[j] < 0:     # first segment sets the job's start
                start[j] = t
            active.append(e)
            busy_now += int(widths[e])
            if tracked:
                n_unstarted -= 1
            if inc is not None:
                rows[e] = inc.add(entry_jobs[e], y_ent[e])
            elif multiwindow:
                # A start changes every row's contention; precomputed
                # stages for the old active set no longer apply.  Frequent
                # starts also mean deep ladders would mostly be wasted,
                # so the ramp decays back towards shallow batches.
                if ladder is not None and ladder["stage"] == 0:
                    ladder_ramp = max(2, ladder_ramp // 2)
                flush_ladder(ladder)
                ladder = None
                model_vals = None
        if not active:
            has_pending = (n_unstarted > 0) if tracked \
                else bool((e_start < 0).any())
            if not has_pending:
                break
            if arrivals is not None:
                nxt = next_pending_arrival()
                if nxt > t:
                    # Idle until the next arrival, but never past the
                    # horizon (the cutoff bounds makespan/total_gpu_slots).
                    # Recorded as a zero-active window so time-weighted
                    # stats cover the gap.
                    nt = min(nxt, horizon)
                    events.append(SimEvent(t=t, dt=nt - t, active=0,
                                           contention=0, busy_gpus=0))
                    t = nt
                    continue
            # Unstartable remainder (cannot happen with FIFO queues: the
            # earliest-committed unfinished entry is at the head of all
            # its queues and its predecessor -- committed earlier -- has
            # finished).
            break
        if multiwindow:
            if model_vals is None:
                if ladder is None:
                    ladder = build_ladder(active)
                    # Keep the active list in ladder (guessed-completion)
                    # order: a stage's surviving rows are then contiguous
                    # slices of the stage arrays, so per-window model
                    # access is a view, not a gather.  Active order never
                    # affects outputs (all window quantities are
                    # aggregates or per-entry values).
                    active = list(ladder["ents"])
                s = ladder["stage"]
                model_vals = (ladder["p"][s, s:], ladder["tau"][s, s:],
                              ladder["phi"][s, s:])
            p_arr, tau_arr, phi_raw = model_vals
        elif inc is not None:
            p_arr, tau_arr, phi_raw = inc.window([rows[e] for e in active])
        else:
            sub_jobs = [entry_jobs[e] for e in active]
            Y = cluster.placement_matrix([gpu_sets[e] for e in active])
            model = evaluate(cluster, sub_jobs, Y)
            p_arr, tau_arr, phi_raw = model.p, model.tau, model.phi
        pmax = int(p_arr.max(initial=0))
        peak_p = max(peak_p, pmax)
        if (phi_raw < 1).any():
            # tau > 1 slot/iteration: degenerate calibration; progress
            # fractionally so the simulation still terminates.  (Integer
            # phi upcasts exactly to float64, so skipping the astype on
            # the common path changes nothing downstream.)
            phi = np.maximum(phi_raw.astype(np.float64), 1.0 / tau_arr)
        else:
            phi = phi_raw
        if multiwindow:
            s0 = ladder["stage"]
            act = ladder["ent_arr"][s0:]
            phi_last[act] = phi          # ordering hint for ladder guesses
            rem = ladder["rem"][s0:]
        else:
            act = np.asarray(active, dtype=np.int64)
            rem = rem_ent[act]
        # min of ceils == ceil of min (ceil is monotone), so one scalar
        # ceil after the reduction replaces the array-wide one.
        # Clamp the event window at the horizon so a job cannot "finish"
        # beyond it — horizon_hit runs stop exactly at the cutoff.
        dt = int(max(1, min(np.ceil((rem / phi).min()), horizon - t)))
        rem_after = rem - phi * dt
        if multiwindow:
            ladder["rem"][s0:] = rem_after
        else:
            rem_ent[act] = rem_after
        events.append(SimEvent(t=t, dt=dt, active=len(active),
                               contention=pmax, busy_gpus=busy_now))
        t += dt
        done_mask = rem_after <= 1e-9
        if done_mask.any():
            keep: list[int] = []
            done_now: list[int] = []
            for e, done in zip(active, done_mask):
                if not done:
                    keep.append(e)
                    continue
                done_now.append(e)
                e_finish[e] = t
                if succ[e] < 0:      # last segment completes the job
                    finish[ent_jid[e]] = t
                busy_gpu_slots += (t - e_start[e]) * int(widths[e])
                busy_now -= int(widths[e])
                release_gpus(e)
                if tracked and succ[e] >= 0 and head_ready[succ[e]]:
                    # The successor segment was parked on this completion
                    # (its GPUs were already all at head).
                    s2 = int(succ[e])
                    head_ready[s2] = False
                    heapq.heappush(arrival_wait,
                                   (_arrival_of(s2), int(ent_jid[s2]),
                                    int(ent_seg[s2]), s2))
                if inc is not None:
                    inc.remove(rows.pop(e))
            active = keep
            if multiwindow:
                # Advance the ladder past this window's completions when
                # they match the guessed prefix (stacks depend only on
                # the removed SET, so order within the prefix is free);
                # otherwise drop it and rebuild from the live state.  A
                # ladder exhausted by a long start-free run doubles the
                # ramp so the next batch covers more stages per call.
                model_vals = None
                if active and ladder is not None:
                    k, c = ladder["stage"], len(done_now)
                    if k + c <= ladder["depth"] and \
                            set(ladder["ents"][k:k + c]) == set(done_now):
                        ladder["stage"] = k + c
                    else:
                        if k + c > ladder["depth"] >= len(active):
                            pass          # depth already spans the run
                        elif k + c > ladder["depth"]:
                            ladder_ramp = min(LADDER_DEPTH, ladder_ramp * 2)
                        flush_ladder(ladder)
                        ladder = None
                else:
                    flush_ladder(ladder)
                    ladder = None

    # Charge partial busy slots for entries that started but never finished
    # (horizon hit): without this, utilization is overstated because
    # total_gpu_slots counts their window while busy_gpu_slots ignores it.
    for e in ents_sorted:
        if e_start[e] >= 0 and e_finish[e] < 0:
            busy_gpu_slots += (t - e_start[e]) * int(widths[e])

    completed_mask = finish >= 0
    completed = int(completed_mask.sum())
    horizon_hit = t >= horizon
    makespan = float(finish.max(initial=0)) if not horizon_hit \
        else float(max(t, finish.max(initial=0)))
    if arrivals is not None:
        # JCT is time-in-system: finish minus arrival, not the absolute
        # finish slot (those only coincide when everything arrives at 0).
        jct = (finish[completed_mask]
               - arrivals[completed_mask]).astype(np.float64)
        # Queueing delay is time-to-service: start minus arrival.  Over
        # the same completed set, avg_jct == avg_queueing_delay + the
        # mean in-service time (finish - start) by construction.
        qd = (start[completed_mask]
              - arrivals[completed_mask]).astype(np.float64)
    else:
        jct = finish[completed_mask]
        qd = start[completed_mask].astype(np.float64)
    return SimResult(
        start=start, finish=finish, makespan=makespan,
        avg_jct=float(jct.mean()) if len(jct) else float("inf"),
        avg_queueing_delay=float(qd.mean()) if len(qd) else float("inf"),
        completed=completed,
        horizon_hit=horizon_hit,
        peak_contention=peak_p,
        busy_gpu_slots=busy_gpu_slots,
        total_gpu_slots=makespan * cluster.num_gpus,
        events=events,
    )
