"""Preemption, migration, and elastic resizing on the incremental engines.

The paper's Eq. (3) pins every job to one gang placement for its whole
life (no preemption).  This module relaxes exactly that constraint with a
checkpoint-restart migration primitive on :class:`PlacementState` and
three policies built on it:

  * :func:`evict` -- stop a placed job at an instant ``t``: the committed
    entry is truncated to the work already executed (or removed outright
    if it had not started), the Eq. (15/16) busy-time charge of the
    un-run remainder is refunded, the real-time clocks and the Eq. (6)
    straddler suffix-count lists are pulled back, and the residual work
    comes back as a new :class:`Job` (iterations prorated from the
    committed rho snapshot -- the same progress accounting a
    checkpoint's step counter would record).
  * :func:`replace` -- re-place a residual job on an explicit GPU set
    under the Eq. (16) budget; together with ``evict`` this is migration.
  * :func:`resize` -- ``evict`` with a different worker count, then
    re-place: GADGET-style elastic scaling (arXiv:2202.01158).

Policies (each with a ``@register_chooser`` online form, so the service
daemon drains them decision-for-decision identically to
:func:`~repro_torch.core.api.schedule_arrivals`):

  * ``sjf-bco-dynamic`` -- dynamic re-packing (arXiv:1908.08082).
    Online: each arrival may preempt the latest-finishing running job
    when the trial (on a clone) strictly improves the summed finish of
    {arrival, victim}.  Batch: re-runs the SJF re-pack over the not-yet
    -started jobs at the first few estimated completion instants and
    keeps the better of {SJF-BCO, re-pack} by simulated makespan -- so it
    is <= SJF-BCO on the Fig. 4 grids by construction.
  * ``gadget-elastic`` -- when an arrival cannot be placed, shrink the
    widest running job toward ``elastic_min`` (its marginal-utility
    window's lower edge; the requested G_j is the upper edge) and retry.
  * ``wang-ca`` -- contention-aware ordering baseline (arXiv:2002.10105):
    jobs ordered by descending ring communication share, each placed on
    the candidate minimising (probed contention level p, est finish).
    Non-preemptive -- the control for the leaderboard.

Everything here runs on the bit-identical engine axes: eviction
arithmetic never touches the contention model (pure clock/quota surgery),
and every probe goes through ``refined_rho`` / ``_probe_p``, which are
pinned identical across reference / batched / incremental.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from repro_torch.core.api import (Chooser, PlacementState, ScheduleRequest,
                                  ScheduleResult, bisect_theta, finalize,
                                  nominal_rho, register_chooser,
                                  register_policy, resolve_placement,
                                  schedule_arrivals)
from repro_torch.core.cluster import Cluster
from repro_torch.core.jobs import Job

__all__ = ["evict", "replace", "resize", "evictable"]


# --------------------------------------------------------------------------
# Primitives
# --------------------------------------------------------------------------


def evictable(state: PlacementState, jid: int, t: float) -> bool:
    """Whether :func:`evict` would succeed for ``jid`` at instant ``t``:
    the job has a live entry and at least one full iteration left."""
    e = state._entry_of.get(jid, -1)
    if e < 0:
        return False
    rho, start = state.seg_rho[e], state.seg_start[e]
    t_ev = min(max(float(t), start), start + rho)
    job = state.placed_jobs[state.seg_row[e]]
    iters_done = job.iters * ((t_ev - start) / rho) if rho > 0 \
        else float(job.iters)
    return job.iters - iters_done >= 1.0


def _drop_straddle_fin(state: PlacementState, y: np.ndarray, G: int,
                       old: float, new: float | None) -> None:
    """Remove ``old`` from the straddled servers' sorted finish lists
    (copy-on-write, like commit/observe_finish) and insert ``new``."""
    for s, ys in enumerate(y.tolist()):
        if 0 < ys < G:
            if not state._fin_owned[s]:
                state._straddle_fin[s] = list(state._straddle_fin[s])
                state._fin_owned[s] = True
            fin = state._straddle_fin[s]
            i = bisect.bisect_left(fin, old)
            if i < len(fin) and fin[i] == old:
                fin.pop(i)
            if new is not None:
                bisect.insort(fin, new)


def _remove_entry(state: PlacementState, e: int) -> None:
    """Physically drop assignment entry ``e`` (a never-started segment),
    remapping the entry-indexed links.  The placed ROW stays (marked dead
    via ``placed_fin = -inf`` by the caller) so row indices in
    ``seg_row`` remain stable; evictions are rare, so the O(entries)
    rebuild is fine."""
    del state.assignment[e]
    del state.seg_rho[e]
    del state.seg_start[e]
    del state.seg_quota[e]
    del state.seg_prev[e]
    del state.seg_row[e]
    state.seg_prev = [p - 1 if p > e else p for p in state.seg_prev]
    state._entry_of = {j: (k - 1 if k > e else k)
                       for j, k in state._entry_of.items()}


def evict(state: PlacementState, jid: int, t: float, u: float,
          num_gpus: int | None = None) -> Job | None:
    """Stop job ``jid`` at instant ``t``; return its residual Job.

    The eviction instant is clamped into the entry's committed window
    ``[start, start + rho]``.  Progress is prorated from the committed
    rho snapshot: ``iters_done = F_j * (t_ev - start) / rho`` -- the same
    step-counter arithmetic a checkpoint would record.
    Refuses (returns None) when less than one full iteration remains:
    migrating a nearly-done job can only lose work.

    State surgery (all exact float arithmetic, so a journal replay of the
    same call is bit-identical):

      * ``U[gpus] -= (rho - done) / u`` -- refund the un-run remainder of
        the Eq. (15) charge;
      * ``R`` entries still equal to the planned finish pull back to
        ``t_ev`` (the GPUs free at the eviction, like
        :meth:`~repro_torch.core.api.PlacementState.observe_finish`);
      * the Eq. (6) straddler suffix lists replace the planned finish
        with ``t_ev`` (or just drop it when the segment never started);
      * a started entry is truncated: its quota becomes ``iters_done``
        and its row finish ``t_ev``; a never-started entry is removed
        outright and the previous segment (if any) becomes the job's
        live entry again.

    ``num_gpus`` resizes the residual (elastic scaling); by default the
    residual keeps the victim's worker count (pure migration).
    """
    e = state._entry_of.get(jid, -1)
    if e < 0:
        return None
    _, gpus = state.assignment[e]
    rho, start = state.seg_rho[e], state.seg_start[e]
    row = state.seg_row[e]
    job = state.placed_jobs[row]
    t_ev = min(max(float(t), start), start + rho)
    done = t_ev - start
    iters_done = job.iters * (done / rho) if rho > 0 else float(job.iters)
    iters_left = job.iters - iters_done
    if iters_left < 1.0:
        return None
    residual = dataclasses.replace(
        job, iters=iters_left,
        num_gpus=int(num_gpus) if num_gpus is not None else job.num_gpus)
    fin_old = start + rho                       # exact committed float
    y = state.placed_y[row]
    G = job.num_gpus
    state.U[gpus] -= (rho - done) / u
    mask = state.R[gpus] == fin_old
    state.R[gpus[mask]] = t_ev
    if done > 0.0:
        _drop_straddle_fin(state, y, G, fin_old, t_ev)
        state.seg_quota[e] = iters_done
        state.placed_fin[row] = t_ev
        state.est_finish[jid] = t_ev
    else:
        _drop_straddle_fin(state, y, G, fin_old, None)
        state.placed_fin[row] = -np.inf         # dead row: never overlaps
        prev = state.seg_prev[e]
        _remove_entry(state, e)
        if prev >= 0:
            state._entry_of[jid] = prev
            state.est_finish[jid] = state.placed_fin[state.seg_row[prev]]
        else:
            del state._entry_of[jid]
            del state.est_start[jid]
            del state.est_finish[jid]
    state.preempted = True
    if state.evict_hook is not None:
        state.evict_hook(job, t_ev, residual)
    return residual


def replace(state: PlacementState, job: Job, gpus: np.ndarray,
            theta: float, u: float) -> bool:
    """Re-place a residual job on an explicit GPU set under Eq. (16).

    ``refined_rho`` prices the residual against the live snapshot; the
    commit links it to the evicted entry (``seg_prev``), so the job's
    est_start survives and the simulator runs the segments in order.
    Callers must have advanced the state to the eviction instant
    (``advance_to``), which :func:`evict` guarantees never exceeds."""
    gpus = np.asarray(gpus)
    rho, start = state.refined_rho(job, gpus)
    if float(state.U[gpus].max()) + rho / u > theta + 1e-9:
        return False
    state.commit(job, gpus, rho, start, u)
    return True


def resize(state: PlacementState, jid: int, t: float, num_gpus: int,
           gpus: np.ndarray, theta: float, u: float) -> bool:
    """Elastic resize: evict ``jid`` at ``t`` with a new worker count and
    re-place the residual on ``gpus``.  All-or-nothing via a clone trial:
    the state is untouched unless both halves succeed."""
    trial = state.clone()
    residual = evict(trial, jid, t, u, num_gpus=num_gpus)
    if residual is None or not replace(trial, residual, gpus, theta, u):
        return False
    residual = evict(state, jid, t, u, num_gpus=num_gpus)
    return replace(state, residual, gpus, theta, u)


# --------------------------------------------------------------------------
# Shared candidate scoring (pick_best_finish without the commit)
# --------------------------------------------------------------------------


def _best_candidate(state: PlacementState, job: Job, rho_nom: float,
                    u: float, theta: float
                    ) -> tuple[float, np.ndarray, float, float] | None:
    """The finish-minimising FA-FFP/LBSGF candidate, NOT committed:
    (est_finish, gpus, rho, start) -- exactly the pick
    :func:`~repro_torch.core.api.pick_best_finish` would commit."""
    from repro_torch.core.sjf_bco import fa_ffp, lbsgf
    cands = []
    for picker in (fa_ffp, lbsgf):
        gpus = picker(state, job, rho_nom, u, theta)
        if gpus is not None:
            cands.append(np.asarray(gpus))
    best = None
    for gpus, (rho, start) in zip(cands, state.refined_rho_many(job, cands)):
        if float(state.U[gpus].max()) + rho / u > theta + 1e-9:
            continue
        if best is None or start + rho < best[0]:
            best = (start + rho, gpus, rho, start)
    return best


def _commit_best(state: PlacementState, job: Job, rho_nom: float,
                 u: float, theta: float) -> float | None:
    """Commit :func:`_best_candidate`; return its est finish or None."""
    best = _best_candidate(state, job, rho_nom, u, theta)
    if best is None:
        return None
    fin, gpus, rho, start = best
    state.commit(job, gpus, rho, start, u)
    return fin


# --------------------------------------------------------------------------
# sjf-bco-dynamic (arXiv:1908.08082): re-pack on completions / arrivals
# --------------------------------------------------------------------------


def _pick_victim(state: PlacementState, t: float,
                 exclude: int) -> int | None:
    """The latest-finishing job still running (estimated) at ``t`` --
    the one whose tail the re-pack can most plausibly improve.  Ties by
    jid; deterministic across engines (est_finish is bit-identical)."""
    victim, fin = None, -np.inf
    for jid, f in state.est_finish.items():
        if jid == exclude or f <= t + 1e-9:
            continue
        if f > fin or (f == fin and (victim is None or jid > victim)):
            victim, fin = jid, f
    return victim


def _trial_preempt(state: PlacementState, job: Job, victim: int, t: float,
                   rho_nom: float, u: float, theta: float,
                   cluster: Cluster) -> float | None:
    """Score {evict victim, place job, re-place residual} on a clone;
    return new finish + residual finish (the pair's summed JCT, the
    quantity SJF preemption improves) or None if infeasible.  The
    arrival commits before the residual -- that IS the preemption: the
    shorter job jumps the queue, and the residual resumes behind it on
    whatever the clocks then say -- and the order here is the order the
    live replay (and the daemon's journal bracket) uses."""
    trial = state.clone()                       # hooks cleared by clone
    residual = evict(trial, victim, t, u)
    if residual is None:
        return None
    new_fin = _commit_best(trial, job, rho_nom, u, theta)
    if new_fin is None:
        return None
    res_fin = _commit_best(trial, residual, nominal_rho(cluster, residual),
                           u, theta)
    if res_fin is None:
        return None
    return new_fin + res_fin


@register_chooser("sjf-bco-dynamic")
def sjf_bco_dynamic_chooser(cluster: Cluster, u: float,
                            params: dict) -> Chooser:
    """Online dynamic re-packing: each arrival considers preempting the
    latest-finishing running job.  The preemptive branch is trialled on a
    clone and taken only when it strictly improves the pair's summed
    finish times (arrival + victim) -- shortest-remaining-work-first in
    the two-job restriction, the quantity SJF preemption exists to
    improve -- over the non-preemptive SJF-BCO pick.  Deterministic: the
    accepted trial is re-run on the live state with identical floats,
    which is also what makes the daemon's EVICT journal replay exact."""
    rho_noms: dict[int, float] = {}

    def choose(state: PlacementState, job: Job, theta: float) -> bool:
        """Place ``job``, preempting a running victim when the summed
        pair JCT improves on the plain placement."""
        if job.jid not in rho_noms:
            rho_noms[job.jid] = nominal_rho(cluster, job)
        rho_nom = rho_noms[job.jid]
        base = _best_candidate(state, job, rho_nom, u, theta)
        t = state.now
        victim = _pick_victim(state, t, exclude=job.jid)
        plan = None
        if victim is not None:
            plan = _trial_preempt(state, job, victim, t, rho_nom, u, theta,
                                  cluster)
        base_score = np.inf if base is None \
            else base[0] + state.est_finish[victim] \
            if victim is not None else base[0]
        if plan is not None and plan + 1e-9 < base_score:
            residual = evict(state, victim, t, u)
            _commit_best(state, job, rho_nom, u, theta)
            _commit_best(state, residual, nominal_rho(cluster, residual),
                         u, theta)
            return True
        if base is None:
            return False
        _, gpus, rho, start = base
        state.commit(job, gpus, rho, start, u)
        return True

    return choose


def _replay_assignment(request: ScheduleRequest,
                       base: ScheduleResult) -> PlacementState:
    """Rebuild a live state from a committed schedule: replaying the
    assignment in order through ``refined_rho`` + ``commit`` reproduces
    the exact clocks every entry was committed against."""
    state = PlacementState(request.cluster,
                           engine=request.params.get("engine"))
    for jid, gpus in base.assignment:
        job = request.jobs[jid]
        rho, start = state.refined_rho(job, np.asarray(gpus))
        state.commit(job, np.asarray(gpus), rho, start, request.u)
    return state


def _repack_on_completions(request: ScheduleRequest, base: ScheduleResult
                           ) -> ScheduleResult | None:
    """Batch dynamic re-pack: at each of the first few estimated
    completion instants, evict every job that has not yet started and
    re-place the lot in SJF order against the then-live clocks.  Each
    event is trialled on a clone and adopted only when it tightens the
    estimated makespan.  Evicting a never-started job is a clean removal
    (done == 0), so the result is a pure re-pack -- no job is split."""
    cluster, u = request.cluster, request.u
    jobs = request.jobs
    state = _replay_assignment(request, base)
    theta = base.theta
    events = sorted(set(state.est_finish.values()))
    changed = False
    for t_c in events[: int(request.params.get("repack_events", 4))]:
        trial = state.clone()
        trial.advance_to(t_c)
        pend = [j for j, s in trial.est_start.items() if s > t_c + 1e-9]
        if not pend:
            continue
        ok = True
        residuals = []
        for j in sorted(pend, key=lambda j: (jobs[j].num_gpus, j)):
            r = evict(trial, j, t_c, u)
            if r is None:
                ok = False
                break
            residuals.append(r)
        if ok:
            for r in residuals:
                if _commit_best(trial, r, nominal_rho(cluster, r), u,
                                theta) is None:
                    ok = False
                    break
        if ok and max(trial.est_finish.values()) + 1e-9 \
                < max(state.est_finish.values()):
            state = trial
            changed = True
    if not changed:
        return None
    return finalize(state, len(jobs), theta, base.kappa, "SJF-BCO-DYN")


@register_policy("sjf-bco-dynamic")
def sjf_bco_dynamic_policy(request: ScheduleRequest) -> ScheduleResult:
    """Dynamic re-packing on completions (arXiv:1908.08082).

    Batch: a portfolio over {SJF-BCO, completion-event re-pack} decided
    by *simulated* makespan, so the policy is never worse than SJF-BCO
    on the batch grids.  Online: :func:`sjf_bco_dynamic_chooser`.
    ``params``: everything sjf-bco takes, plus ``repack_events`` (how
    many completion instants the batch re-pack examines, default 4)."""
    from repro_torch.core.simulator import simulate
    from repro_torch.core.sjf_bco import sjf_bco_policy
    if not request.is_batch:
        return schedule_arrivals(
            request,
            sjf_bco_dynamic_chooser(request.cluster, request.u,
                                    request.params),
            "SJF-BCO-DYN")
    base = sjf_bco_policy(request)
    repack = _repack_on_completions(request, base)
    if repack is None:
        return dataclasses.replace(base, policy="SJF-BCO-DYN")
    sim_base = simulate(request.cluster, request.jobs, base.assignment,
                        quotas=base.quotas)
    sim_re = simulate(request.cluster, request.jobs, repack.assignment,
                      quotas=repack.quotas)
    if sim_re.makespan < sim_base.makespan:
        return repack
    return dataclasses.replace(base, policy="SJF-BCO-DYN")


# --------------------------------------------------------------------------
# gadget-elastic (arXiv:2202.01158): shrink-on-pressure worker scaling
# --------------------------------------------------------------------------


def _pick_widest(state: PlacementState, t: float, emin: int) -> int | None:
    """The widest job still running (estimated) at ``t`` whose worker
    count can shrink toward ``emin``.  Ties by jid."""
    victim, width = None, 0
    for jid, e in state._entry_of.items():
        if state.est_finish.get(jid, -np.inf) <= t + 1e-9:
            continue
        g = state.placed_jobs[state.seg_row[e]].num_gpus
        if g // 2 >= emin and g > emin and \
                (g > width or (g == width and (victim is None
                                               or jid > victim))):
            victim, width = jid, g
        # (the g // 2 >= emin guard keeps the shrink meaningful)
    return victim


@register_chooser("gadget-elastic")
def gadget_elastic_chooser(cluster: Cluster, u: float,
                           params: dict) -> Chooser:
    """Online GADGET-style elasticity: place like sjf-bco; on placement
    failure, shrink the widest running job to max(elastic_min, G // 2)
    -- the lower edge of its marginal-utility window (the requested G_j
    is the upper edge) -- and place {arrival, shrunk residual}.  The
    elastic branch is all-or-nothing via a clone trial."""
    rho_noms: dict[int, float] = {}
    emin = int(params.get("elastic_min", 1))

    def choose(state: PlacementState, job: Job, theta: float) -> bool:
        """Place ``job``; on failure, shrink the widest running job and
        place {arrival, shrunk residual} all-or-nothing."""
        if job.jid not in rho_noms:
            rho_noms[job.jid] = nominal_rho(cluster, job)
        if _commit_best(state, job, rho_noms[job.jid], u, theta) is not None:
            return True
        t = state.now
        victim = _pick_widest(state, t, emin)
        if victim is None:
            return False
        width = state.placed_jobs[
            state.seg_row[state._entry_of[victim]]].num_gpus
        shrunk = max(emin, width // 2)
        trial = state.clone()
        residual = evict(trial, victim, t, u, num_gpus=shrunk)
        if residual is None:
            return False
        if _commit_best(trial, job, rho_noms[job.jid], u, theta) is None:
            return False
        if _commit_best(trial, residual, nominal_rho(cluster, residual),
                        u, theta) is None:
            return False
        residual = evict(state, victim, t, u, num_gpus=shrunk)
        _commit_best(state, job, rho_noms[job.jid], u, theta)
        _commit_best(state, residual, nominal_rho(cluster, residual),
                     u, theta)
        return True

    return choose


@register_policy("gadget-elastic")
def gadget_elastic_policy(request: ScheduleRequest) -> ScheduleResult:
    """GADGET-style elastic scheduling (arXiv:2202.01158): the epoch loop
    with :func:`gadget_elastic_chooser` -- batch is the arrivals == 0
    special case, like RAND.  ``params``: ``elastic_min`` (smallest
    worker count a job may shrink to, default 1), plus ``engine``."""
    resolve_placement(request.params)           # validate, scalar-only
    return schedule_arrivals(
        request,
        gadget_elastic_chooser(request.cluster, request.u, request.params),
        "GADGET-ELASTIC")


# --------------------------------------------------------------------------
# wang-ca (arXiv:2002.10105): contention-aware ordering baseline
# --------------------------------------------------------------------------


def _comm_share(job: Job) -> float:
    """Ring communication share: per-worker exchanged bytes
    2 * (G-1)/G * grad_size -- the quantity Wang et al. order by."""
    return 2.0 * job.grad_size * (job.num_gpus - 1) / job.num_gpus


def _wang_place(state: PlacementState, job: Job, rho_nom: float, u: float,
                theta: float) -> bool:
    """Place ``job`` on the FA-FFP/LBSGF candidate minimising the probed
    Eq. (6) contention level p first, est finish second.  ``_probe_p``
    is engine-independent, so the pick is bit-identical across engines."""
    from repro_torch.core.sjf_bco import fa_ffp, lbsgf
    cands = []
    for picker in (fa_ffp, lbsgf):
        gpus = picker(state, job, rho_nom, u, theta)
        if gpus is not None:
            cands.append(np.asarray(gpus))
    best = None                   # (p, est_finish, gpus, rho, start)
    for gpus, (rho, start) in zip(cands, state.refined_rho_many(job, cands)):
        if float(state.U[gpus].max()) + rho / u > theta + 1e-9:
            continue
        p, _ = state._probe_p(job, state._y_of(gpus), start)
        key = (p, start + rho)
        if best is None or key < best[:2]:
            best = (p, start + rho, gpus, rho, start)
    if best is None:
        return False
    _, _, gpus, rho, start = best
    state.commit(job, gpus, rho, start, u)
    return True


@register_chooser("wang-ca")
def wang_ca_chooser(cluster: Cluster, u: float, params: dict) -> Chooser:
    """Online Wang et al. contention-aware rule: the arrival order is the
    stream's own; each job takes the minimum-contention candidate."""
    rho_noms: dict[int, float] = {}

    def choose(state: PlacementState, job: Job, theta: float) -> bool:
        """Place ``job`` on its minimum-(probed p, est finish) candidate."""
        if job.jid not in rho_noms:
            rho_noms[job.jid] = nominal_rho(cluster, job)
        return _wang_place(state, job, rho_noms[job.jid], u, theta)

    return choose


@register_policy("wang-ca")
def wang_ca_policy(request: ScheduleRequest) -> ScheduleResult:
    """Contention-aware ordering baseline (arXiv:2002.10105).

    Batch: theta bisection over an attempt that places jobs in descending
    ring-communication-share order (heaviest communicators first, while
    the cluster is emptiest), each on the candidate minimising (probed
    contention level, est finish).  Non-preemptive; the leaderboard's
    ordering-only control."""
    cluster, u = request.cluster, request.u
    resolve_placement(request.params)           # validate, scalar-only
    engine = request.params.get("engine")
    if not request.is_batch:
        return schedule_arrivals(
            request, wang_ca_chooser(cluster, u, request.params), "WANG-CA")
    jobs = request.jobs
    order = sorted(jobs, key=lambda j: (-_comm_share(j), j.jid))
    rho_noms = {j.jid: nominal_rho(cluster, j) for j in jobs}

    def attempt(theta: float) -> ScheduleResult | None:
        """One Alg. 1 trial at ``theta`` over the comm-share order."""
        state = PlacementState(cluster, engine=engine)
        for job in order:
            if not _wang_place(state, job, rho_noms[job.jid], u, theta):
                return None
        return finalize(state, len(jobs), theta, None, "WANG-CA")

    return bisect_theta(attempt, request.horizon, "WANG-CA",
                        floor=max(rho_noms.values()) / u)
