"""SJF-BCO: Smallest Job First with Balanced Contention and Overhead.

Implements the paper's Algorithm 1 (bisection on the per-GPU execution-time
budget theta_u, sweep over the small/large-job threshold kappa), Algorithm 2
(FA-FFP, fragment-aware first-fit packing, used when G_j <= kappa) and
Algorithm 3 (LBSGF, least-busy-server-GPU-first, used when G_j > kappa).

Accounting follows §5-3 and lives in :mod:`repro_torch.core.api`
(:class:`~repro_torch.core.api.PlacementState`, :func:`~repro_torch.core.api.try_place`,
:func:`~repro_torch.core.api.bisect_theta`): every GPU carries an accumulated
busy-time clock U, charged rho_hat_j(y^k) / u per placed job (Eq. 15), and
placement is feasible only while U stays within theta_u (Eq. 16) -- this is
what Lemma 2 certifies.  The actual makespan is later produced by
``repro_torch.core.simulator`` which re-evaluates contention slot by slot.

The paper's "wait for some job to exit and retry" (Alg. 2 line 9, Alg. 3
line 12) concerns run-time availability; in the static busy-time accounting
waiting never reduces U, so an insufficient feasible-GPU set is reported as
infeasible for the current (theta_u, kappa), matching Alg. 1 line 14.

With ``request.arrivals`` set, the policy runs the online epoch loop
(:func:`~repro_torch.core.api.schedule_arrivals`): at each arrival the job is
placed against the live busy-time clocks with the finish-minimising
pack-or-spread choice between FA-FFP and LBSGF -- under open-ended
arrivals there is no theta bisection to spread load, so queueing delay
itself is the penalty that balances the two subroutines.
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.core.api import (Chooser, PlacementState, ScheduleRequest,
                            ScheduleResult, SharedState, bisect_theta,
                            finalize, nominal_rho, pick_best_finish,
                            register_chooser, register_policy,
                            resolve_columnar_backend, resolve_placement,
                            rho_hat, schedule_arrivals, try_place,
                            try_place_group)
from repro_torch.core.cluster import Cluster
from repro_torch.core.columnar import ColumnarPlacement, _flat_ids, server_sums
from repro_torch.core.jobs import Job

__all__ = ["fa_ffp", "lbsgf", "nominal_rho", "rho_hat", "sjf_bco_policy"]


def fa_ffp(state: PlacementState, job: Job, rho_nom: float, u: float,
           theta: float) -> np.ndarray | None:
    """Algorithm 2: Fragment-Aware First-Fit Packing (small jobs).

    Feasible pool = GPUs whose busy time stays within theta after the job
    (Alg. 2 line 2).  Fragment-awareness (the stated intuition of §5-4):
    prefer to pack the whole job into a single, already-occupied server --
    best-fit on feasible capacity -- so small jobs neither fragment empty
    servers nor straddle links; fall back to globally least-loaded GPUs
    (least-execution-time-first, the property Lemma 4(b) relies on) when no
    single server fits."""
    cl = state.cluster
    feasible = (state.U + rho_nom / u <= theta + 1e-9).nonzero()[0]
    if len(feasible) < job.num_gpus:
        return None
    srv_of = cl.gpu_server[feasible]
    # All candidate servers scored in one vectorised pass: feasible-GPU
    # count and total occupancy per server, then best fit = fewest feasible
    # slots left after placing, preferring servers that already carry work
    # (pack, don't open fresh servers), lowest server id on ties.
    cnt = np.bincount(srv_of, minlength=cl.num_servers)
    fits = (cnt >= job.num_gpus).nonzero()[0]
    if len(fits):
        # bincount-with-weights sums U in GPU-id order, exactly like the
        # np.add.at it replaces (same additions, same order), ~10x faster.
        occupied = np.bincount(cl.gpu_server, weights=state.U,
                               minlength=cl.num_servers)
        order = np.lexsort((fits, -occupied[fits], cnt[fits] - job.num_gpus))
        best_srv = int(fits[order[0]])
        pool = feasible[srv_of == best_srv]
        order = pool[np.argsort(state.U[pool], kind="stable")]
        return order[: job.num_gpus]
    order = feasible[np.argsort(state.U[feasible], kind="stable")]
    return order[: job.num_gpus]


def lbsgf(state: PlacementState, job: Job, rho_nom: float, u: float,
          theta: float) -> np.ndarray | None:
    """Algorithm 3: Least-Busy-Server-GPU-First (large jobs).

    Sort servers by average GPU busy time; take the top-m least-busy servers
    with cumulative capacity >= lambda_j * G_j (line 2); walk those servers
    in least-busy order appending their feasible GPUs sorted by U (lines
    4-5), and take the first G_j (line 7).  Server-major order packs the
    ring into the emptiest few servers — which is what makes a larger
    lambda (a wider server pool) monotonically reduce contention+overhead,
    the Fig. 7 behaviour."""
    cl = state.cluster
    srv_of = cl.gpu_server
    caps = cl.capacities_array
    srv_load = np.bincount(srv_of, weights=state.U,
                           minlength=cl.num_servers)
    srv_order = np.argsort(srv_load / caps, kind="stable")
    need = job.lam * job.num_gpus
    cum = np.cumsum(caps[srv_order])
    m = int(np.searchsorted(cum, need) + 1)
    m = min(m, cl.num_servers)
    selected = srv_order[:m]
    srv_rank = np.full(cl.num_servers, -1, dtype=np.int64)
    srv_rank[selected] = np.arange(m)

    pool = (state.U + rho_nom / u <= theta + 1e-9).nonzero()[0]
    pool = pool[srv_rank[srv_of[pool]] >= 0]
    if len(pool) < job.num_gpus:
        return None
    ranks = srv_rank[srv_of[pool]]
    order = np.lexsort((state.U[pool], ranks))   # server-major, then least U
    return pool[order][: job.num_gpus]


def _fa_ffp_many(cluster: Cluster, U: np.ndarray, feasible: np.ndarray,
                 job: Job) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised FA-FFP over a batch of branch rows.

    ``U`` [rows, N] holds each branch row's busy-time clocks and
    ``feasible`` [rows, N] its Eq. (16) pool; returns ``(gpus, ok)`` with
    ``gpus`` [rows, G_j] and ``ok`` [rows] (False where the pool is too
    small -- :func:`fa_ffp` returns None there).  Every row reproduces the
    scalar pick exactly: the per-server counts/occupancies come from the
    same GPU-id-order bincounts (:func:`~repro_torch.core.columnar.server_sums`),
    the best-fit server from one flat lexsort whose within-row keys match
    the scalar lexsort (ties broken identically by lexsort stability), and
    the within-server / fallback orders from stable argsorts over masked
    keys, which order ties by GPU id exactly like the scalar pool sorts."""
    R, N = U.shape
    S = cluster.num_servers
    Gj = job.num_gpus
    ok = feasible.sum(axis=1) >= Gj
    # One flat bincount covers both per-server reductions (pool counts and
    # occupancy): rows 0..R-1 count the feasible pool, rows R..2R-1 sum the
    # clocks.  Bins are disjoint per row, so each row's additions keep
    # their GPU-id order (concatenate upcasts bool -> 0.0/1.0 exactly like
    # the astype it replaces).
    both = server_sums(cluster, np.concatenate([feasible, U]))
    cnt = both[:R].astype(np.int64)
    occupied = both[R:]
    fits = cnt >= Gj
    has_fit = fits.any(axis=1)
    any_fit = bool(has_fit.any())
    packed = None
    if any_fit:
        # Best server per row by (fewest feasible slots left, most
        # occupied, lowest id): one flat lexsort with the row as the
        # primary key, so row r's candidates occupy positions
        # r*S..(r+1)*S-1 of the order.
        r_flat = _flat_ids("rep", R, S)
        s_flat = _flat_ids("tile", R, S)
        # k_fit ranges over [0, N+1], so folding it into the row key
        # (row * (N+2) + k_fit) preserves the (row, k_fit) lexicographic
        # order exactly while dropping one full sort pass.
        k_fit = (r_flat * (N + 2)
                 + np.where(fits, cnt - Gj, N + 1).ravel())
        k_occ = np.where(fits, -occupied, np.inf).ravel()
        order = np.lexsort((s_flat, k_occ, k_fit))
        best_srv = s_flat[order[::S]]
        in_best = feasible \
            & (cluster.gpu_server[None, :] == best_srv[:, None])
        packed = np.argsort(np.where(in_best, U, np.inf), axis=1,
                            kind="stable")[:, :Gj]
        if has_fit.all():
            return packed, ok
    spread = np.argsort(np.where(feasible, U, np.inf), axis=1,
                        kind="stable")[:, :Gj]
    if not any_fit:
        return spread, ok
    return np.where(has_fit[:, None], packed, spread), ok


def _lbsgf_many(cluster: Cluster, U: np.ndarray, feasible: np.ndarray,
                job: Job) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised LBSGF over a batch of branch rows.

    Same contract as :func:`_fa_ffp_many`.  Per row: server loads from the
    GPU-id-order bincount, the least-busy server order from a stable
    argsort of load/capacity (ties by server id, as in the scalar
    argsort), the lambda_j-sized top-m pool from the same cumulative
    -capacity threshold count, and the final server-major/least-U GPU
    order from one flat lexsort whose within-row keys equal the scalar
    ``np.lexsort((U[pool], ranks))`` -- so every row's pick is
    bit-identical to :func:`lbsgf`."""
    R, N = U.shape
    S = cluster.num_servers
    Gj = job.num_gpus
    caps = cluster.capacities_array
    srv_load = server_sums(cluster, U)
    srv_order = np.argsort(srv_load / caps[None, :], axis=1, kind="stable")
    need = job.lam * Gj
    cum = np.cumsum(caps[srv_order], axis=1)
    m = np.minimum((cum < need).sum(axis=1) + 1, S)
    pos = np.arange(S)[None, :]
    rank_vals = np.where(pos < m[:, None], pos, -1)
    srv_rank = np.empty((R, S), dtype=np.int64)
    # Scatter along axis 1 directly (put_along_axis minus its per-call
    # index-grid construction): row r gets rank_vals[r] at srv_order[r].
    rows_col = np.arange(R)[:, None]
    srv_rank[rows_col, srv_order] = rank_vals
    ranks = srv_rank[rows_col, cluster.gpu_server[None, :]]
    pool = feasible & (ranks >= 0)
    ok = pool.sum(axis=1) >= Gj
    # k_rank ranges over [0, S+1]; folded into the row key it preserves
    # the (row, rank) lexicographic order exactly (one sort pass fewer).
    k_rank = (_flat_ids("rep", R, N) * (S + 2)
              + np.where(pool, ranks, S + 1).ravel())
    k_U = np.where(pool, U, np.inf).ravel()
    order = np.lexsort((k_U, k_rank))
    gpus = order.reshape(R, N)[:, :Gj] - (np.arange(R) * N)[:, None]
    return gpus, ok


# theta enters both pickers only through the U + rho/u <= theta + 1e-9
# feasibility pool, which is what lets the speculative bisection advance a
# whole group of thetas in lockstep (see api.try_place_group) and the
# columnar engine batch whole branch stacks per pick (pick_many).
fa_ffp.theta_pool = True
lbsgf.theta_pool = True
fa_ffp.pick_many = _fa_ffp_many
lbsgf.pick_many = _lbsgf_many
# Stable ids under which repro_torch.kernels.placement.pick_orders ranks
# these pickers from the pool kernel's outputs (0 = FA-FFP, 1 = LBSGF);
# pickers without an id make the columnar engine fall back to per-step
# pick_many calls.
fa_ffp.jit_pick_id = 0
lbsgf.jit_pick_id = 1


# The adaptive pack-or-spread choice IS SJF-BCO's online rule (extensions'
# sjf-bco-adaptive shares it), so the chooser registers both names.
@register_chooser("sjf-bco", "sjf-bco-adaptive")
def sjf_bco_chooser(cluster: Cluster, u: float, params: dict) -> Chooser:
    """Online SJF-BCO: the finish-minimising FA-FFP/LBSGF choice of the
    epoch loop, bound to one (cluster, u) context."""
    rho_noms: dict[int, float] = {}

    def choose(state: PlacementState, job: Job, theta: float) -> bool:
        if job.jid not in rho_noms:
            rho_noms[job.jid] = nominal_rho(cluster, job)
        return pick_best_finish(state, job, [fa_ffp, lbsgf],
                                rho_noms[job.jid], u, theta)

    return choose


def _attempt(cluster: Cluster, jobs_sorted: list[Job],
             rho_noms: dict[int, float], u: float, theta: float,
             kappa: int, engine: str | None = None,
             hints: dict[int, np.ndarray] | None = None
             ) -> PlacementState | None:
    """One (theta, kappa) pass of Alg. 1 lines 8-16."""
    state = PlacementState(cluster, engine=engine)
    for job in jobs_sorted:
        picker = fa_ffp if job.num_gpus <= kappa else lbsgf
        hint = hints.get(job.jid) if hints else None
        if not try_place(state, job, picker, rho_noms[job.jid], u, theta,
                         hint=hint):
            return None
    return state


def _sweep_batched(cluster: Cluster, jobs_sorted: list[Job],
                   rho_noms: dict[int, float], u: float, theta: float,
                   kappas: list[int], engine: str | None,
                   hints: dict[int, np.ndarray] | None
                   ) -> dict[int, ScheduleResult | None]:
    """Every kappa branch of one theta, sharing placed prefixes.

    In sorted-job order the branch for kappa places jobs with G_j <= kappa
    via FA-FFP and the rest via LBSGF, so for ascending kappas the FA-FFP
    prefix of one branch is a prefix of the next branch's: each prefix
    segment is placed ONCE into a shared :class:`PlacementState` and every
    branch forks off it (:meth:`PlacementState.clone`) for its LBSGF
    suffix.  Placement is deterministic given the state, so each branch's
    schedule -- and a prefix placement failure, which dooms every kappa at
    or above the failing job's size -- is bit-identical to running
    :func:`_attempt` per kappa from scratch."""
    n = len(jobs_sorted)
    shared = PlacementState(cluster, engine=engine)
    results: dict[int, ScheduleResult | None] = {}
    idx = 0                       # next job to absorb into the shared prefix
    prefix_ok = True
    for kappa in sorted(set(kappas)):
        while prefix_ok and idx < n and jobs_sorted[idx].num_gpus <= kappa:
            job = jobs_sorted[idx]
            hint = hints.get(job.jid) if hints else None
            if not try_place(shared, job, fa_ffp, rho_noms[job.jid], u,
                             theta, hint=hint):
                prefix_ok = False                              # line 14
                break
            idx += 1
        if not prefix_ok:
            results[kappa] = None
            continue
        # All jobs placed already: later branches add nothing, so the
        # shared state needs no fork (it is never committed to again).
        state = shared.clone() if idx < n else shared
        ok = True
        for job in jobs_sorted[idx:]:
            hint = hints.get(job.jid) if hints else None
            if not try_place(state, job, lbsgf, rho_noms[job.jid], u, theta,
                             hint=hint):
                ok = False                                     # line 14
                break
        results[kappa] = finalize(state, n, theta, kappa, "SJF-BCO") \
            if ok else None
    return results


def _sweep_speculative(cluster: Cluster, jobs_sorted: list[Job],
                       rho_noms: dict[int, float], u: float,
                       thetas: list[float], kappas: list[int],
                       engine: str | None
                       ) -> dict[float, dict[int, ScheduleResult | None]]:
    """Every (theta, kappa) attempt of one speculative bisection round.

    Extends :func:`_sweep_batched`'s shared-prefix idea to the theta axis:
    all thetas of a probe ladder start from ONE shared
    :class:`PlacementState` and advance in lockstep
    (:func:`~repro_torch.core.api.try_place_group`), splitting -- with
    copy-on-write clones -- only where the theta budgets actually change
    a placement decision.  Within each theta group the kappa branches
    fork off shared FA-FFP prefixes exactly as in the batched sweep.
    Decision-for-decision identical to running :func:`_sweep_batched`
    per theta, which is itself bit-identical to :func:`_attempt`."""
    n = len(jobs_sorted)
    thetas_arr = np.asarray(sorted(thetas), dtype=np.float64)
    results: dict[float, dict[int, ScheduleResult | None]] = \
        {float(th): {} for th in thetas_arr}
    # Live prefix groups (thetas, state holder, next job to absorb) plus
    # the theta ranges whose shared prefix failed -- a prefix failure at
    # one kappa dooms every kappa at or above it (Alg. 1 line 14), so
    # doomed ranges stay doomed for the rest of the sweep.
    groups = [(thetas_arr, SharedState(PlacementState(cluster,
                                                      engine=engine)), 0)]
    doomed: list[np.ndarray] = []
    for kappa in sorted(set(kappas)):
        work, groups = groups, []
        while work:
            th_g, holder, idx = work.pop()
            if idx < n and jobs_sorted[idx].num_gpus <= kappa:
                job = jobs_sorted[idx]
                for sub, sh, ok in try_place_group(
                        th_g, holder, job, fa_ffp, rho_noms[job.jid], u):
                    if ok:
                        work.append((sub, sh, idx + 1))
                    else:
                        doomed.append(sub)
            else:
                groups.append((th_g, holder, idx))
        for sub in doomed:
            for th in sub:
                results[float(th)][kappa] = None
        for th_g, holder, idx in groups:
            if idx == n:
                # All jobs live in the prefix: nothing to fork (the state
                # is never committed to again), as in the batched sweep.
                for th in th_g:
                    results[float(th)][kappa] = \
                        finalize(holder.state, n, float(th), kappa, "SJF-BCO")
                continue
            holder.split(2)          # one ref stays with the prefix
            swork = [(th_g, holder, idx)]
            while swork:
                th_s, sh, j = swork.pop()
                if j == n:
                    for th in th_s:
                        results[float(th)][kappa] = \
                            finalize(sh.state, n, float(th), kappa, "SJF-BCO")
                    sh.release()
                    continue
                job = jobs_sorted[j]
                for sub, sh2, ok in try_place_group(
                        th_s, sh, job, lbsgf, rho_noms[job.jid], u):
                    if ok:
                        swork.append((sub, sh2, j + 1))
                    else:
                        for th in sub:
                            results[float(th)][kappa] = None
    return results


@obs.spanned("sched.sweep")
def _sweep_columnar(cluster: Cluster, jobs: list[Job],
                    jobs_sorted: list[Job], rho_noms: dict[int, float],
                    u: float, thetas: list[float], kappas: list[int],
                    engine: str | None, backend: str = "numpy",
                    device=None
                    ) -> dict[float, dict[int, ScheduleResult | None]]:
    """Every (theta, kappa) attempt as ONE columnar array program.

    Each (theta, kappa) pair is a branch of a single
    :class:`~repro_torch.core.columnar.ColumnarPlacement`; one :meth:`place`
    call per sorted job advances the whole forest -- the kappa axis enters
    purely as the per-branch FA-FFP/LBSGF picker assignment (G_j <= kappa
    packs, else spreads), the theta axis purely through the Eq. (16)
    pools.  Branches whose decisions coincide share one state row (and
    re-merge when they re-coincide), which subsumes both the batched
    sweep's shared FA-FFP prefixes and the speculative bisection's
    copy-on-write lineages.  Decision-for-decision identical to
    :func:`_attempt` per pair, hence bit-identical schedules."""
    kap = sorted(set(kappas))
    pairs = [(float(th), k) for th in sorted(thetas) for k in kap]
    col = ColumnarPlacement(cluster, [th for th, _ in pairs], jobs, u,
                            engine=engine, backend=backend, device=device)
    kappa_arr = np.asarray([k for _, k in pairs], dtype=np.int64)
    # Jobs repeat few distinct sizes, and the picker split depends only on
    # G_j -- one assignment array per size instead of one per job.
    picker_by_G: dict[int, np.ndarray] = {}
    for job in jobs_sorted:
        picker_of = picker_by_G.get(job.num_gpus)
        if picker_of is None:
            picker_of = (job.num_gpus > kappa_arr).astype(np.int64)
            picker_by_G[job.num_gpus] = picker_of
        col.place(job, rho_noms[job.jid], (fa_ffp, lbsgf), picker_of)
        if not col.n_live:
            break                                              # line 14
    results: dict[float, dict[int, ScheduleResult | None]] = \
        {float(th): {} for th in thetas}
    for b, (th, k) in enumerate(pairs):
        results[th][k] = col.result(b, th, k, "SJF-BCO")
    return results


@register_policy("sjf-bco")
def sjf_bco_policy(request: ScheduleRequest) -> ScheduleResult:
    """Algorithm 1 (batch) / finish-minimising epoch scheduler (online).

    ``request.params``:
      * ``kappas`` -- candidate small/large thresholds to sweep (batch
        only); defaults to the distinct job sizes, which is equivalent to
        the paper's 1..max_j G_j sweep.
      * ``engine`` -- contention-model engine (see
        :class:`~repro_torch.core.api.PlacementState`).
      * ``sweep`` -- ``"batched"`` (default) runs all kappa branches of a
        theta off shared placed prefixes (jobs below a branch's kappa
        place identically in every branch at or above it, so each FA-FFP
        prefix segment is placed once); ``"sequential"`` is the reference
        one-kappa-at-a-time loop.  Both produce bit-identical schedules
        (pinned by tests and the CI bench smoke).
      * ``bisect`` -- ``"speculative"`` (default) scores the whole probe
        ladder of each bisection round (:func:`~repro_torch.core.api.probe_thetas`)
        in one :func:`_sweep_speculative` pass and commits several theta
        decisions at once; ``"sequential"`` is the one-theta-at-a-time
        Alg. 1 oracle.  Bit-identical final (theta, kappa, placements);
        pinned by ``tests/test_bisect_equivalence.py`` and the CI bench
        smoke.  Speculation needs the batched sweep's shared-prefix
        structure and a cold start, so ``sweep="sequential"`` or
        ``warm_start=True`` fall back to the sequential bisection.
      * ``bisect_levels`` -- how many bisection decisions each
        speculative round precomputes (the probe ladder is the
        descending assume-feasible chain, at most one probe per level).
        Default 4 for the scalar walk, 8 for the columnar engine (an
        extra probe theta there is one more branch row of the same
        array ops).
      * ``bisect_prune`` -- whether the ladder drops tail probes below
        the bracket's likely-infeasible cutoff (default: pruned for the
        scalar walk, unpruned for columnar).  Never changes results,
        only which probes are precomputed.
      * ``warm_start`` -- seed each theta's attempts with the placements
        committed at the previous feasible theta (off by default; changes
        the search trajectory, not the accounting).
      * ``placement`` -- ``"scalar"`` is the per-branch
        :class:`~repro_torch.core.api.PlacementState` walk, the
        bit-identity oracle (host NumPy only); ``"columnar"`` advances the
        whole (theta, kappa) forest of each attempt/round as one
        :class:`~repro_torch.core.columnar.ColumnarPlacement` array
        program with deduplicated branch rows -- identical decisions held
        in strictly-array state.  Unset, the default is scalar
        (``api.COLUMNAR_DEFAULT_MIN_JOBS`` is ``None``);
        :func:`~repro_torch.core.scenario.run_scenario` on a CUDA device
        asks for columnar.  Columnar needs the cold-start batched sweep
        (hints change decisions), so ``sweep="sequential"`` or
        ``warm_start=True`` fall back to the scalar walk.
      * ``columnar_backend`` -- where the columnar step's array math
        runs: ``"auto"`` (default; ``"kernel"`` on a CUDA ``device``,
        ``"numpy"`` on the CPU), ``"kernel"`` (the CUDA pool/score
        kernels, or their plain versions on a CPU device) or ``"numpy"``
        -- bit-identical in float64 (see
        :func:`~repro_torch.core.api.resolve_columnar_backend`).
      * ``device`` -- the ``"kernel"`` backend's device (default
        ``"cuda"``; see :func:`repro_torch.resolve_device`).
    """
    cluster, u = request.cluster, request.u
    engine = request.params.get("engine")
    placement = resolve_placement(
        request.params, len(request.jobs) if request.is_batch else None)
    sweep = request.params.get("sweep", "batched")
    if sweep not in ("batched", "sequential"):
        raise ValueError(
            f"unknown sweep mode {sweep!r}; choose 'batched' or 'sequential'")
    bisect_mode = request.params.get("bisect", "speculative")
    if bisect_mode not in ("speculative", "sequential"):
        raise ValueError(f"unknown bisect mode {bisect_mode!r}; "
                         "choose 'speculative' or 'sequential'")
    if not request.is_batch:
        # The one online code path: the same chooser factory that
        # repro.service pulls via get_chooser("sjf-bco").
        return schedule_arrivals(
            request, sjf_bco_chooser(cluster, u, request.params), "SJF-BCO")

    jobs = request.jobs
    jobs_sorted = sorted(jobs, key=lambda j: (j.num_gpus, j.jid))   # line 3
    rho_noms = {j.jid: nominal_rho(cluster, j) for j in jobs}
    kappas = request.params.get("kappas")
    if kappas is None:
        # Only kappa values at distinct job sizes change the FA-FFP/LBSGF
        # split; sweeping them is equivalent to the paper's 1..max_j G_j.
        kappas = sorted({j.num_gpus for j in jobs})
        if 1 not in kappas:
            kappas.insert(0, 1)

    warm = bool(request.params.get("warm_start"))
    use_columnar = placement == "columnar" and sweep == "batched" and not warm
    backend = resolve_columnar_backend(request.params) if use_columnar \
        else "numpy"
    device = request.params.get("device")

    def attempt(theta: float,
                prev: ScheduleResult | None = None) -> ScheduleResult | None:
        hints = dict(prev.assignment) if prev is not None else None
        if use_columnar:
            sweep_results = _sweep_columnar(cluster, jobs, jobs_sorted,
                                            rho_noms, u, [theta], kappas,
                                            engine, backend,
                                            device)[float(theta)]
        elif sweep == "batched":
            sweep_results = _sweep_batched(cluster, jobs_sorted, rho_noms,
                                           u, theta, kappas, engine, hints)
        best_theta: ScheduleResult | None = None
        for kappa in kappas:                                       # line 7
            if use_columnar or sweep == "batched":
                cand = sweep_results[kappa]
            else:
                state = _attempt(cluster, jobs_sorted, rho_noms, u, theta,
                                 kappa, engine=engine, hints=hints)
                cand = finalize(state, len(jobs), theta, kappa, "SJF-BCO") \
                    if state is not None else None                 # line 14
            if cand is None:
                continue
            if best_theta is None or cand.est_makespan < best_theta.est_makespan:
                best_theta = cand                                  # lines 17-18
        return best_theta

    attempt_many = None
    if bisect_mode == "speculative" and sweep == "batched" and not warm:
        def attempt_many(thetas: list[float]
                         ) -> dict[float, ScheduleResult | None]:
            if use_columnar:
                sweep_results = _sweep_columnar(cluster, jobs, jobs_sorted,
                                                rho_noms, u, thetas, kappas,
                                                engine, backend, device)
            else:
                sweep_results = _sweep_speculative(cluster, jobs_sorted,
                                                   rho_noms, u, thetas,
                                                   kappas, engine)
            out: dict[float, ScheduleResult | None] = {}
            for th in thetas:
                best_theta: ScheduleResult | None = None
                for kappa in kappas:                               # line 7
                    cand = sweep_results[th][kappa]
                    if cand is None:
                        continue
                    if best_theta is None \
                            or cand.est_makespan < best_theta.est_makespan:
                        best_theta = cand                          # lines 17-18
                out[th] = best_theta
            return out

    # The columnar program prices an extra probe theta at one more branch
    # row of the same array ops, so it keeps the whole ladder (no bracket
    # pruning) and speculates deeper by default; the scalar walk pays one
    # placement lineage per probe and keeps the conservative ladder.
    default_levels = 8 if use_columnar else 4
    return bisect_theta(attempt, request.horizon, "SJF-BCO",
                        warm_start=warm, attempt_many=attempt_many,
                        levels=int(request.params.get("bisect_levels",
                                                      default_levels)),
                        floor=max(rho_noms.values()) / u,
                        prune=bool(request.params.get("bisect_prune",
                                                      not use_columnar)))
