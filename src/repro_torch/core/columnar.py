"""Columnar branch-vectorised placement: the whole sweep x bisect forest
as one array program.

The speculative machinery of :mod:`repro_torch.core.api` (``SharedState`` +
``try_place_group``) advances a *lineage forest* of per-branch
:class:`~repro_torch.core.api.PlacementState` objects: branches fork with
copy-on-write clones at the first divergent placement and never re-merge,
so cross-theta sharing decays to ~5-15% and the scheduler remains a scalar
Python walk per lineage.  :class:`ColumnarPlacement` replaces the forest
with a columnar layout:

  * every (theta, kappa) **branch** maps onto a deduplicated state **row**;
    the row store is a pair of ``[rows, N]`` clock matrices (busy-time U,
    real-time R) plus ONE shared append-only decision-log arena -- flat
    ``jid``/``start``/``finish``/``gpus`` columns threaded by per-record
    parent pointers, so a row is just a tail index into the arena and
    cloning a row costs O(N + S) regardless of how many jobs it has placed
    (the O(placed) per-clone list copies of the first columnar engine were
    the 16k-scale bottleneck);
  * each :meth:`place` call advances **every** live branch by one job as
    masked vectorised ops: the Eq. (16) pools (``U + rho/u <= theta``) are
    threshold counts on one sorted vector per row, the FA-FFP/LBSGF/FF/LS
    argmin picks run as one ``picker.pick_many`` call over the whole
    ``[groups, N]`` batch, refined-rho probes are scored for all groups in
    one :func:`~repro_torch.core.contention.scalar_tau_many` /
    :func:`~repro_torch.core.contention.evaluate_stack` pass, and the Eq. (16)
    re-check splits each theta run with a single vectorised comparison;
  * with ``backend="kernel"`` the pool split, the per-server reductions
    and the FA-FFP best server run as one CUDA kernel launch per step
    (one block per work row), and the heterogeneous Eq. (6)-(8) probe
    scoring as another, from :mod:`repro_torch.kernels.placement`; the
    stable pick rankings stay host NumPy.  On a CPU device the same
    wrappers run the kernels' plain PyTorch versions.  ``backend="numpy"``
    keeps the eager NumPy ops.  Both are bit-identical in float64;
  * branches whose decisions coincide are **re-merged**: a committed step
    is a pure function of (parent row, chosen GPU set), so children are
    deduplicated by the ``(parent row, gpus)`` key -- exactly the state
    hash the COW forest cannot exploit once lineages have forked.

Decision-for-decision the engine replays :func:`repro_torch.core.api.try_place`
per branch: the same pool thresholds, the same picker tie-breaks (the
``pick_many`` forms are elementwise-identical to the scalar pickers), the
same memoised rho_hat(y^k) scores, the same ``max(rho, rho_try * 1.05)``
escalation ladder, and the same float expressions in the same order -- so
schedules are bit-identical to the scalar oracle (pinned against the
reference's scalar walk by ``tests/test_torch_scenario.py``).
The engine backs ``placement="columnar"`` of the bisection policies; the
scalar walk stays selectable as ``placement="scalar"``.
"""
from __future__ import annotations

import array as _arr
import bisect as _bisect

import numpy as np

from repro_torch import obs, resolve_device
from repro_torch.core import contention
from repro_torch.core.cluster import Cluster
from repro_torch.core.contention import (_job_terms, evaluate_stack,
                                   predict_exec_time, resolve_engine,
                                   scalar_tau, scalar_tau_many, slots_for,
                                   slots_for_many)
from repro_torch.core.jobs import Job

__all__ = ["ColumnarPlacement", "server_sums", "COLUMNAR_BACKENDS"]

#: Selectable math backends for the columnar step (see module docstring).
COLUMNAR_BACKENDS = ("numpy", "kernel")


# Flat index arrays reused across millions of small pick/score batches
# ([rows ~ 10-50, N ~ 100-300]); at those shapes the allocations cost more
# than the reductions they feed.  Entries are marked read-only -- they are
# only ever lexsort keys / gather indices.  Keys are (kind, R, M): "rep" =
# np.repeat(arange(R), M), "tile" = np.tile(arange(M), R).
_FLAT_IDS: dict[tuple[str, int, int], np.ndarray] = {}


def _flat_ids(kind: str, R: int, M: int) -> np.ndarray:
    a = _FLAT_IDS.get((kind, R, M))
    if a is None:
        a = (np.repeat(np.arange(R), M) if kind == "rep"
             else np.tile(np.arange(M), R))
        a.setflags(write=False)
        _FLAT_IDS[(kind, R, M)] = a
    return a


def server_sums(cluster: Cluster, W: np.ndarray) -> np.ndarray:
    """Per-(row, server) sums of a ``[rows, N]`` per-GPU weight matrix.

    The batched form of ``np.bincount(cluster.gpu_server, weights=w)``:
    one flat bincount over row-major keys accumulates every (row, server)
    bin in GPU-id order -- the same additions in the same order as the
    scalar pickers' per-server bincounts, so the sums are bit-identical
    per row.  Shared by the vectorised ``pick_many`` forms of FA-FFP
    (occupancy scores) and LBSGF (server loads)."""
    R, N = W.shape
    S = cluster.num_servers
    cache = cluster._batch_key_cache
    keys = cache.get(R)
    if keys is None:
        keys = (np.arange(R)[:, None] * S
                + cluster.gpu_server[None, :]).ravel()
        keys.setflags(write=False)
        cache[R] = keys
    return np.bincount(keys, weights=np.ascontiguousarray(W).ravel(),
                       minlength=R * S).reshape(R, S)


class _Work:
    """One resolution-ladder work item: a run of branches sharing a row, a
    picker, the current escalated rho, and the memoised candidate scores
    (shared down the retry chain, as in ``try_place_group``)."""

    __slots__ = ("row", "pid", "branches", "rho_try", "scored")

    def __init__(self, row: int, pid: int, branches: np.ndarray,
                 rho_try: float, scored: dict):
        self.row = row
        self.pid = pid
        self.branches = branches
        self.rho_try = rho_try
        self.scored = scored


class ColumnarPlacement:
    """Branch-vectorised placement over ``[rows, N]`` clock matrices.

    ``thetas`` fixes the branch axis: branch ``b`` replays the scalar
    placement walk at budget ``thetas[b]`` (callers encode the kappa sweep
    by assigning pickers per branch in :meth:`place`).  ``jobs`` is the
    request's jid-indexed job list (the per-jid Eq. (8) terms and the
    reference-engine snapshots are gathered from it).  ``engine`` selects
    how rho_hat(y^k) probes evaluate, exactly as for
    :class:`~repro_torch.core.api.PlacementState`: ``"incremental"`` suffix
    counts + one ``scalar_tau_many`` per step, ``"batched"`` one padded
    :func:`~repro_torch.core.contention.evaluate_stack` pass over the branch
    stack, ``"reference"`` the per-candidate ``evaluate`` loop.
    ``backend`` selects where the step's array math runs: ``"numpy"``
    (eager host NumPy) or ``"kernel"`` (the
    :mod:`repro_torch.kernels.placement` wrappers on ``device``: CUDA
    kernels on a CUDA device, their plain versions on the CPU) -- both
    bit-identical.
    """

    #: try_place's escalation-ladder depth (same constant, same semantics).
    TRIES = 4

    def __init__(self, cluster: Cluster, thetas, jobs: list[Job], u: float,
                 engine: str | None = None, backend: str = "numpy",
                 device=None):
        self.cluster = cluster
        self.engine = resolve_engine(engine)
        if backend not in COLUMNAR_BACKENDS:
            raise ValueError(
                f"unknown columnar backend {backend!r}; choose one of "
                f"{COLUMNAR_BACKENDS}")
        self.backend = backend
        self._kern = None
        self._device = None
        if backend == "kernel":
            from repro_torch.kernels import placement as _kern
            self._kern = _kern
            self._device = resolve_device("cuda" if device is None
                                          else device)
        self.u = float(u)
        self.jobs = jobs
        self.thetas = np.asarray(thetas, dtype=np.float64)
        B = len(self.thetas)
        if B == 0:
            raise ValueError("columnar placement needs at least one branch")
        self.n_branches = B
        self.n_jobs = len(jobs)
        self.alive = np.ones(B, dtype=bool)
        self.row_of = np.zeros(B, dtype=np.int64)
        # Placement-independent Eq. (8) terms, gathered by jid for the
        # batched-engine branch stacks.
        self._G_t, self._share_t, self._compute_t = _job_terms(jobs)

        N = cluster.num_gpus
        S = cluster.num_servers
        cap = max(1, B)
        self.U = np.zeros((cap, N))          # busy-time clocks (Eq. 15/16)
        self.R = np.zeros((cap, N))          # real-time clocks (gang start)
        self._free = list(range(1, cap))
        self._live_rows: set[int] = {0}
        # The shared decision-log arena: one append-only record per
        # committed (child row, jid) decision, flat columns + a parent
        # pointer chain.  A row's history is the chain from its tail
        # record; rows are just (tail, count) pairs, so clones never copy
        # decision lists and result() gathers chains as fancy-indexed
        # NumPy views over the arena columns.
        self._log_jid = _arr.array("q")
        self._log_prev = _arr.array("q")
        self._log_start = _arr.array("d")
        self._log_fin = _arr.array("d")
        self._log_g: list[np.ndarray] = []
        self._log_y: list[np.ndarray] = []
        self._tail: dict[int, int] = {0: -1}
        self._count: dict[int, int] = {0: 0}
        # Per-step caches over the arena (invalidated on commit).
        self._chain_cache: dict[int, np.ndarray] = {}
        self._y_cache: dict[int, np.ndarray] = {}
        # Per-server sorted est_finish of straddling placed jobs, shared
        # copy-on-write between cloned rows (see PlacementState.clone).
        self._straddle_fin: dict[int, list[list[float]]] = \
            {0: [[] for _ in range(S)]}
        self._fin_owned: dict[int, list[bool]] = {0: [True] * S}
        # Running decision-history fingerprint (the dedup "state hash").
        self._state_hash: dict[int, int] = {0: 0}
        # Picker tuple already validated by place() (identity-cached).
        self._checked_pickers: tuple | None = None
        self._pick_ids: np.ndarray | None = None
        # Branch thetas as plain floats for the singleton-run scalar
        # compares (the vector form stays in self.thetas).
        self._thetas_f = self.thetas.tolist()
        # Live-branch counter (place() kills branches; O(1) liveness for
        # the sweep's early-exit check).
        self._n_live = B
        # Per-job rho memo for the homogeneous incremental engine: Eq. (8)
        # depends on the candidate only through (p, n_srv), and a step's
        # candidates hit a handful of distinct pairs -- one scalar_tau per
        # distinct pair replaces whole scalar_tau_many/score_probes calls
        # (bit-identical: the scalar expression is pinned equal to the
        # vectorised and kernel forms).
        self._rho_memo: dict[tuple[int, int], float] = {}
        self._rho_memo_jid = -1

    # -- row store ---------------------------------------------------------

    def _alloc_row(self) -> int:
        if not self._free:
            cap = self.U.shape[0]
            grow = np.zeros_like(self.U)
            self.U = np.concatenate([self.U, grow])
            self.R = np.concatenate([self.R, np.zeros_like(grow)])
            self._free.extend(range(cap, 2 * cap))
        r = self._free.pop()
        self._live_rows.add(r)
        return r

    def _free_row(self, r: int) -> None:
        self._live_rows.discard(r)
        self._free.append(r)
        for store in (self._tail, self._count, self._chain_cache,
                      self._y_cache, self._straddle_fin, self._fin_owned,
                      self._state_hash):
            store.pop(r, None)

    def _clone_row(self, parent: int) -> int:
        """Copy-on-write fork of a row (the columnar PlacementState.clone):
        O(N + S) copies -- the decision history is a tail pointer into the
        shared arena, and the sorted-finish lists are shared until a
        commit first writes into one (both sides drop ownership)."""
        r = self._alloc_row()
        self.U[r] = self.U[parent]
        self.R[r] = self.R[parent]
        self._tail[r] = self._tail[parent]
        self._count[r] = self._count[parent]
        self._straddle_fin[r] = list(self._straddle_fin[parent])
        S = self.cluster.num_servers
        self._fin_owned[r] = [False] * S
        self._fin_owned[parent] = [False] * S
        self._state_hash[r] = self._state_hash[parent]
        return r

    # -- decision-log gathers ----------------------------------------------

    def _chain(self, row: int) -> np.ndarray:
        """Arena record indices of ``row``'s decisions, oldest first
        (cached per step; a chain walk is O(placed) but runs only for
        engines/results that need the full history)."""
        idx = self._chain_cache.get(row)
        if idx is None:
            n = self._count[row]
            idx = np.empty(n, dtype=np.int64)
            i = self._tail[row]
            prev = self._log_prev
            for k in range(n - 1, -1, -1):
                idx[k] = i
                i = prev[i]
            self._chain_cache[row] = idx
        return idx

    def _row_cols(self, row: int) -> tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
        """(jids, starts, finishes) of ``row``'s decisions, oldest first,
        gathered zero-copy from the arena columns."""
        idx = self._chain(row)
        if not len(idx):
            z = np.empty(0, dtype=np.int64)
            return z, np.empty(0), np.empty(0)
        return (np.frombuffer(self._log_jid, dtype=np.int64)[idx],
                np.frombuffer(self._log_start, dtype=np.float64)[idx],
                np.frombuffer(self._log_fin, dtype=np.float64)[idx])

    def _row_Y(self, row: int) -> np.ndarray:
        """Stacked per-decision occupancy rows ``[placed, S]`` of ``row``
        (cached per step; only the batched/reference engines need it)."""
        Y = self._y_cache.get(row)
        if Y is None:
            idx = self._chain(row)
            S = self.cluster.num_servers
            ylog = self._log_y
            Y = (np.stack([ylog[i] for i in idx.tolist()])
                 if len(idx) else np.zeros((0, S), dtype=np.int64))
            self._y_cache[row] = Y
        return Y

    # -- scoring (rho_hat(y^k) probes, batched over candidates) ------------

    def _score(self, job: Job, need: list[tuple["_Work", bytes, np.ndarray]]
               ) -> None:
        """Score every unseen (row, gpus) candidate of this step in one
        engine pass and fill the work items' memo dicts with
        ``(rho, start, y)``.  Values are bit-identical to
        ``PlacementState.refined_rho`` on the equivalent scalar state."""
        cl = self.cluster
        S = cl.num_servers
        C = len(need)
        G = job.num_gpus
        # All candidates place the same G-gang, so starts and occupancy
        # rows come from two batched gathers instead of C bincounts.
        rows_n = np.fromiter((w.row for w, _, _ in need), np.int64, C)
        gmat = np.concatenate([g for _, _, g in need]).reshape(C, G)
        starts = (self.R[rows_n[:, None], gmat].max(axis=1) if G
                  else np.zeros(C))
        # Integer counts per (candidate, server): one flat bincount (same
        # counts as the np.add.at it replaces, far cheaper per call).
        ys_mat = np.bincount(_flat_ids("rep", C, G) * S
                             + cl.gpu_server[gmat.ravel()],
                             minlength=C * S).reshape(C, S)
        ys = list(ys_mat)
        if self.engine == "incremental":
            ns = (ys_mat > 0).sum(axis=1)
            ps = np.zeros(C, dtype=np.int64)
            cuts = starts + 1e-9
            # Contention probes only on actually-straddled (c, s) pairs
            # (same max-over-servers as the scalar probe, same bisects).
            pc, psrv = np.nonzero((ys_mat > 0) & (ys_mat < G))
            for c, s in zip(pc.tolist(), psrv.tolist()):
                fin = self._straddle_fin[need[c][0].row][s]
                cnt = len(fin) - _bisect.bisect_right(fin, cuts[c]) + 1
                if cnt > ps[c]:
                    ps[c] = cnt
            if not cl.is_heterogeneous:
                # Homogeneous clusters: Eq. (8) sees the candidate only
                # through (p, n_srv), and a step's candidates hit a
                # handful of distinct pairs -- one memoised scalar_tau
                # per pair (bit-identical to scalar_tau_many AND to the
                # score kernel: the scalar expression chain is pinned
                # equal to both) replaces the whole batched / dispatched
                # evaluation on every backend.
                memo = self._rho_memo
                if self._rho_memo_jid != job.jid:
                    memo.clear()
                    self._rho_memo_jid = job.jid
                ns_l = ns.tolist()
                ps_l = ps.tolist()
                rhos = []
                for c in range(C):
                    pair = (ps_l[c], ns_l[c])
                    r = memo.get(pair)
                    if r is None:
                        r = memo[pair] = slots_for(
                            job.iters, scalar_tau(cl, job, *pair))
                    rhos.append(r)
            elif self._kern is not None:
                # One score-kernel launch over the candidate batch
                # (bit-identical to the scalar_tau_many expressions).
                _, rhos = self._kern.score_probes(
                    cl, job, ys_mat, ps.astype(np.float64),
                    device=self._device)
            else:
                speed, bw_sh, bw_iso = contention._hetero_mins(
                    cl, ys_mat > 0)
                taus = scalar_tau_many(cl, job, ps, ns, speed=speed,
                                       bw_shared=bw_sh, bw_isolated=bw_iso)
                rhos = slots_for_many(job.iters, taus)
        elif self.engine == "batched":
            rhos = self._score_batched(job, need, starts, ys)
        else:                                   # "reference"
            rhos = np.empty(C)
            for c, (w, _, g) in enumerate(need):
                jids, _, fins = self._row_cols(w.row)
                cut = starts[c] + 1e-9
                keep = fins > cut
                overlap = jids[keep]
                Y_snap = self._row_Y(w.row)[keep]
                rhos[c] = predict_exec_time(
                    cl, job, [self.jobs[j] for j in overlap.tolist()],
                    Y_snap, ys[c])
        # One bulk tolist instead of C float() casts (same float64 values).
        rhos_l = rhos if type(rhos) is list else rhos.tolist()
        starts_l = starts.tolist()
        for c, (w, key, g) in enumerate(need):
            w.scored[key] = (rhos_l[c], starts_l[c], ys[c])

    def _score_batched(self, job: Job, need, starts: np.ndarray,
                       ys: list[np.ndarray]) -> np.ndarray:
        """All candidates in one padded-branch-stack ``evaluate_stack``
        pass: candidate c's rows are its row's placed jobs (inactive where
        their window misses the candidate's start) plus the candidate
        itself; per-candidate term rows are gathered by jid.  Padding rows
        stay inactive/zero, which leaves active rows' contention untouched
        (a zero row straddles nothing)."""
        cl = self.cluster
        S = cl.num_servers
        C = len(need)
        counts = [self._count[w.row] for (w, _, _) in need]
        Pmax = max(counts)
        Y = np.zeros((C, Pmax + 1, S), dtype=np.int64)
        active = np.zeros((C, Pmax + 1), dtype=bool)
        Gt = np.zeros((C, Pmax + 1), dtype=np.int64)
        sh = np.zeros((C, Pmax + 1))
        # Padding rows keep compute=1 so their (never-read) tau stays
        # finite; their Y rows are zero, so they perturb nothing active.
        cp = np.ones((C, Pmax + 1))
        wG, wsh, wcp = _job_terms([job])
        for c, (w, _, g) in enumerate(need):
            P = counts[c]
            if P:
                jids, _, fins = self._row_cols(w.row)
                Y[c, :P] = self._row_Y(w.row)
                active[c, :P] = fins > starts[c] + 1e-9
                Gt[c, :P] = self._G_t[jids]
                sh[c, :P] = self._share_t[jids]
                cp[c, :P] = self._compute_t[jids]
            Y[c, P] = ys[c]
            active[c, P] = True
            Gt[c, P] = wG[0]
            sh[c, P] = wsh[0]
            cp[c, P] = wcp[0]
        model = evaluate_stack(cl, Gt, sh, cp, Y, active=active)
        taus = np.asarray([model.tau[c, counts[c]] for c in range(C)])
        return slots_for_many(job.iters, taus)

    # -- the one-job step --------------------------------------------------

    def place(self, job: Job, rho_nom: float, pickers, picker_of) -> None:
        """Advance every live branch by one job.

        ``pickers`` is the tuple of candidate pickers (each carrying the
        ``theta_pool`` contract and a vectorised ``pick_many``);
        ``picker_of`` assigns one to each branch (scalar or ``[branches]``
        array of indices into ``pickers`` -- the kappa axis of SJF-BCO).
        Branches sharing (row, picker) advance in lockstep and split only
        where the scalar walk's decisions diverge; committed branches are
        re-merged onto deduplicated child rows.
        """
        sp = obs.open_span("columnar.place") if obs.on else -1
        if pickers is not self._checked_pickers:
            for picker in pickers:
                if not getattr(picker, "theta_pool", False) \
                        or getattr(picker, "pick_many", None) is None:
                    raise ValueError(
                        f"picker {getattr(picker, '__name__', picker)!r} "
                        "lacks theta_pool/pick_many; the columnar engine "
                        "needs theta to enter only through the feasibility "
                        "pool and a vectorised pick")
            self._checked_pickers = pickers
            # The pool kernel's outputs rank FA-FFP/LBSGF; pickers without
            # a jit_pick_id fall back to their pick_many per step.
            ids = [getattr(p, "jit_pick_id", -1) for p in pickers]
            self._pick_ids = np.asarray(ids, dtype=np.int64) \
                if self._kern is not None and min(ids) >= 0 else None
        if not self._n_live:
            if sp >= 0:
                obs.close_span(sp)
            return
        live = np.flatnonzero(self.alive)
        u = self.u
        fused = self._pick_ids is not None
        picker_of = np.asarray(picker_of, dtype=np.int64)
        if picker_of.shape != (self.n_branches,):
            picker_of = np.broadcast_to(picker_of, (self.n_branches,))
        # Contiguous (row, picker) work groups, branches theta-ascending
        # (then branch id) within each -- one stable lexsort instead of a
        # python dict walk.
        rows_l = self.row_of[live]
        pids_l = picker_of[live]
        order = np.lexsort((live, self.thetas[live], pids_l, rows_l))
        lb, rb, pb = live[order], rows_l[order], pids_l[order]
        gcuts = np.flatnonzero((rb[1:] != rb[:-1]) | (pb[1:] != pb[:-1])) + 1
        bounds = np.concatenate([[0], gcuts, [len(lb)]])
        work = [_Work(int(rb[s]), int(pb[s]), lb[s:e], rho_nom, {})
                for s, e in zip(bounds[:-1], bounds[1:])]
        commits: list[tuple] = []   # (branches, row, gpus, rho, start, y, gb)
        dead: list[np.ndarray] = []
        first_try = True
        for _ in range(self.TRIES):
            if sp >= 0:
                obs.COUNTERS["columnar.tries"] += 1
            # Pool split: within each work item, group branches by how many
            # GPUs clear the rho_try filter -- equal counts <=> equal pools
            # (threshold sets are nested in theta), hence identical picks.
            # The counts at each item's extreme thetas come from one
            # batched compare over the [work, N] clock block; only items
            # whose extremes disagree (rare) pay the full per-theta split.
            nw = len(work)
            if first_try:
                # Round 0 (the common case): every item sits at rho_nom
                # and its branch run is a contiguous slice of the
                # lexsorted (lb, rb, pb) arrays, so the group stats are
                # direct gathers instead of four python fromiter walks.
                first_try = False
                heads = bounds[:-1]
                rows_w = rb[heads]
                rho_w = np.full(nw, rho_nom)
                th_lo = self.thetas[lb[heads]]
                th_hi = self.thetas[lb[bounds[1:] - 1]]
                pid_w = pb[heads]
            else:
                rows_w = np.fromiter((w.row for w in work), np.int64, nw)
                rho_w = np.fromiter((w.rho_try for w in work),
                                    np.float64, nw)
                th_lo = self.thetas[np.fromiter(
                    (w.branches[0] for w in work), np.int64, nw)]
                th_hi = self.thetas[np.fromiter(
                    (w.branches[-1] for w in work), np.int64, nw)]
                pid_w = np.fromiter((w.pid for w in work), np.int64, nw)
            ord_w = ok_w = None
            # The kernel backend dispatches every step, whatever the batch
            # height: no dispatch threshold has been measured on the card.
            U_w = self.U[rows_w]
            if fused:
                # One pool-kernel launch: pools at both extremes, the
                # per-server reductions and each work item's full pick
                # ordering under its picker, ranked on the device.
                V, c_lo, c_hi, ord_w, ok_w = self._kern.pick_orders(
                    self.cluster, U_w, th_lo, th_hi, rho_w / u,
                    self._pick_ids[pid_w], job, device=self._device)
            else:
                V = U_w + (rho_w / u)[:, None]
                # Pool counts only matter where an item's extreme thetas
                # differ (equal thetas => equal pools trivially); most
                # items are singletons, so the compares usually vanish.
                multi = th_lo != th_hi
                c_lo = np.zeros(nw, dtype=np.int64)
                c_hi = c_lo
                if multi.any():
                    c_hi = np.zeros(nw, dtype=np.int64)
                    Vm = V[multi]
                    c_lo[multi] = (Vm <= th_lo[multi][:, None]
                                   + 1e-9).sum(axis=1)
                    c_hi[multi] = (Vm <= th_hi[multi][:, None]
                                   + 1e-9).sum(axis=1)
            runs: list[tuple[_Work, np.ndarray, int]] = []
            c_lo_l, c_hi_l = c_lo.tolist(), c_hi.tolist()
            for i, w in enumerate(work):
                if len(w.branches) == 1 or c_lo_l[i] == c_hi_l[i]:
                    runs.append((w, w.branches, i))
                else:
                    counts = np.searchsorted(np.sort(V[i]),
                                             self.thetas[w.branches] + 1e-9,
                                             side="right")
                    cuts = np.flatnonzero(counts[1:] != counts[:-1]) + 1
                    for sub in np.split(w.branches, cuts):
                        runs.append((w, sub, i))
            nr = len(runs)
            # nr == nw <=> no item split, and then run i IS work item i.
            v_idx = (np.arange(nw) if nr == nw
                     else np.fromiter((r[2] for r in runs), np.int64, nr))
            rows_r = rows_w[v_idx]
            picks: list[np.ndarray | None] = [None] * nr
            pending: list[int] = []
            if fused:
                # The program ranked each work item's th_lo pool; any run
                # whose pool equals it (all non-split runs, and a split's
                # lowest-theta sub) reads its pick off the precomputed
                # ordering.  Higher split subs (rare) fall back below.
                G = job.num_gpus
                for i, (w, sub, wi) in enumerate(runs):
                    if len(sub) == len(w.branches) or c_lo[wi] == c_hi[wi] \
                            or sub[0] == w.branches[0]:
                        picks[i] = ord_w[wi, :G] if ok_w[wi] else None
                    else:
                        pending.append(i)
            else:
                pending = list(range(nr))
            if pending:
                if len(pending) == nr == nw:
                    # Whole-batch numpy round with no splits (the common
                    # case): run i IS work item i, so the representative
                    # theta per run is exactly th_lo and the [nw, N]
                    # clock gathers U_w/V are reused without copies.
                    th_rep = th_lo
                    U_all = U_w
                    feas_all = V <= th_rep[:, None] + 1e-9
                else:
                    th_rep = self.thetas[np.fromiter(
                        (runs[i][1][0] for i in pending), np.int64,
                        len(pending))]
                    p_idx = v_idx[pending]
                    U_all = self.U[rows_r[pending]]
                    feas_all = V[p_idx] <= th_rep[:, None] + 1e-9
                # Vectorised picks: one pick_many call per distinct picker
                # over the whole [pending, N] batch.
                by_pid: dict[int, list[int]] = {}
                for j, i in enumerate(pending):
                    by_pid.setdefault(runs[i][0].pid, []).append(j)
                for pid, idxs in sorted(by_pid.items()):
                    if len(idxs) == len(pending):  # single-picker fast path
                        U_g, feas = U_all, feas_all
                    else:
                        U_g, feas = U_all[idxs], feas_all[idxs]
                    gp, okv = pickers[pid].pick_many(self.cluster, U_g,
                                                     feas, job)
                    okl = okv.tolist()
                    for j, jj in enumerate(idxs):
                        picks[pending[jj]] = gp[j] if okl[j] else None
            # Batched scoring of every first-seen candidate of this level.
            # One pass over the runs collects the dead (no pick), the
            # survivors (ok_i/ok_g) and the unseen candidates to score;
            # keys_r memoises each run's candidate bytes so the commit
            # loop below reads the memo without re-serialising.
            need: list[tuple[_Work, bytes, np.ndarray]] = []
            keys_r: list[bytes | None] = [None] * nr
            ok_i: list[int] = []
            ok_g: list[np.ndarray] = []
            for i, (w, sub, _) in enumerate(runs):
                g = picks[i]
                if g is None:
                    dead.append(sub)
                    continue
                key = g.tobytes()
                keys_r[i] = key
                ok_i.append(i)
                ok_g.append(g)
                if key not in w.scored:
                    w.scored[key] = None      # claimed; filled by _score
                    need.append((w, key, g))
            if need:
                if sp >= 0:
                    sc = obs.open_span("columnar.score")
                    self._score(job, need)
                    obs.close_span(sc)
                else:
                    self._score(job, need)
            # Eq. (16) re-check: each run splits into a committing upper
            # theta range and a retrying lower one.  All runs place the
            # same G-gang, so the refined-rho bounds come from one batched
            # [picked, G] gather instead of a max() per run.
            next_work: list[_Work] = []
            ok_sc = [runs[i][0].scored[keys_r[i]] for i in ok_i]
            if ok_i:
                gmat = np.concatenate(ok_g).reshape(len(ok_g),
                                                    job.num_gpus)
                rhos = np.fromiter((sc[0] for sc in ok_sc), np.float64,
                                   len(ok_sc))
                bnd = (self.U[rows_r[ok_i][:, None], gmat]
                       + (rhos / u)[:, None]).max(axis=1).tolist()
                thetas_f = self._thetas_f
                for j, i in enumerate(ok_i):
                    w, sub, _ = runs[i]
                    rho, start, y = ok_sc[j]
                    if len(sub) == 1:
                        # Singleton run (the common case): one scalar
                        # compare, no boolean mask / fancy indexing.
                        if thetas_f[sub[0]] + 1e-9 >= bnd[j]:
                            commits.append((sub, w.row, ok_g[j], rho,
                                            start, y, keys_r[i]))
                        else:
                            next_work.append(_Work(
                                w.row, w.pid, sub,
                                max(rho, w.rho_try * 1.05), w.scored))
                        continue
                    passes = self.thetas[sub] + 1e-9 >= bnd[j]
                    hi, lo = sub[passes], sub[~passes]
                    if len(hi):
                        commits.append((hi, w.row, ok_g[j], rho, start, y,
                                        keys_r[i]))
                    if len(lo):
                        next_work.append(_Work(w.row, w.pid, lo,
                                               max(rho, w.rho_try * 1.05),
                                               w.scored))
            work = next_work
            if not work:
                break
        for w in work:                        # escalation ladder exhausted
            dead.append(w.branches)
        self._apply(job, commits, dead)
        if sp >= 0:
            obs.close_span(sp)

    def _apply(self, job: Job, commits: list[tuple],
               dead: list[np.ndarray]) -> None:
        """Fold a step's outcomes into the row store: kill failed branches,
        dedup commits by (parent row, gpus) -- the re-merge the lineage
        forest cannot do -- clone rows only at true divergences, and apply
        all clock/est updates as one vectorised write per matrix."""
        jid = job.jid
        for bs in dead:
            if len(bs):
                self.alive[bs] = False
                self._n_live -= len(bs)
        # Merge identical decisions: a child state is a pure function of
        # (parent row, committed gpus), so branches picking the same set
        # off the same row land on ONE child row.
        merged: dict[tuple[int, bytes], list] = {}
        for bs, row, g, rho, start, y, gb in commits:
            key = (row, gb)
            ent = merged.get(key)
            if ent is None:
                merged[key] = [bs, row, g, rho, start, y, gb]
            else:
                ent[0] = np.concatenate([ent[0], bs])
        by_parent: dict[int, list] = {}
        for ent in merged.values():        # dicts keep insertion order
            by_parent.setdefault(ent[1], []).append(ent)
        # Assign child rows: the first class reuses the parent in place
        # (every branch leaves it this step), the rest fork copy-on-write.
        child_rows: list[tuple[int, list]] = []
        for parent in sorted(by_parent):
            classes = by_parent[parent]
            for k, ent in enumerate(classes):
                child = parent if k == 0 else self._clone_row(parent)
                child_rows.append((child, ent))
        if child_rows:
            self._chain_cache.clear()
            self._y_cache.clear()
            u = self.u
            rows_arr = np.asarray([c for c, _ in child_rows])
            gmat = np.concatenate(
                [ent[2] for _, ent in child_rows]).reshape(
                    len(child_rows), job.num_gpus)
            rhos = np.asarray([ent[3] for _, ent in child_rows])
            starts = np.asarray([ent[4] for _, ent in child_rows])
            # The columnar Eq. (15) charge: one masked write per matrix.
            # (Index pairs are unique: child rows are distinct and a gang's
            # GPUs are distinct, so the fancy += is the scalar addition.)
            self.U[rows_arr[:, None], gmat] += (rhos / u)[:, None]
            self.R[rows_arr[:, None], gmat] = (starts + rhos)[:, None]
            G = job.num_gpus
            fins = (starts + rhos).tolist()
            for child, ent in child_rows:
                bs, _, g, rho, start, y, gb = ent
                self.row_of[bs] = child
                fin = start + rho
                rec = len(self._log_jid)
                self._log_jid.append(jid)
                self._log_prev.append(self._tail[child])
                self._log_start.append(start)
                self._log_fin.append(fin)
                self._log_g.append(g)
                self._log_y.append(y)
                self._tail[child] = rec
                self._count[child] += 1
                self._state_hash[child] = hash(
                    (self._state_hash[child], jid, gb))
            # Straddled (child, server) pairs in one batched scan (the
            # per-child flatnonzero dominated this loop); argwhere's
            # row-major order reproduces the per-child, server-ascending
            # insort order exactly.
            ymat = np.concatenate(
                [ent[5] for _, ent in child_rows]).reshape(
                    len(child_rows), self.cluster.num_servers)
            sc_ci, sc_s = np.nonzero((ymat > 0) & (ymat < G))
            for ci, s in zip(sc_ci.tolist(), sc_s.tolist()):
                child = child_rows[ci][0]
                sf = self._straddle_fin[child]
                owned = self._fin_owned[child]
                if not owned[s]:                 # copy-on-first-write
                    sf[s] = list(sf[s])
                    owned[s] = True
                _bisect.insort(sf[s], fins[ci])
        # Release rows no branch references any more.
        referenced = set(self.row_of[self.alive].tolist())
        for r in [r for r in self._live_rows if r not in referenced]:
            self._free_row(r)

    # -- results -----------------------------------------------------------

    @property
    def n_rows(self) -> int:
        """Distinct live states (the dedup the lineage forest lacks)."""
        return len(self._live_rows)

    @property
    def n_live(self) -> int:
        """Live branches, tracked O(1) (== ``alive.sum()``)."""
        return self._n_live

    def state_hash(self, b: int) -> int | None:
        """Decision-history fingerprint of branch ``b`` (None if dead)."""
        if not self.alive[b]:
            return None
        return self._state_hash[int(self.row_of[b])]

    def result(self, b: int, theta: float, kappa: int | None,
               policy: str):
        """Freeze branch ``b`` into a ScheduleResult (None if it failed).
        Same construction as :func:`repro_torch.core.api.finalize` on the
        equivalent scalar state."""
        from repro_torch.core.api import ScheduleResult
        if not self.alive[b]:
            return None
        row = int(self.row_of[b])
        est_start = np.full(self.n_jobs, -1.0)
        est_finish = np.full(self.n_jobs, -1.0)
        idx = self._chain(row)
        jids, starts, fins = self._row_cols(row)
        if len(idx):
            est_start[jids] = starts
            est_finish[jids] = fins
        glog = self._log_g
        assignment = [(int(j), glog[i])
                      for j, i in zip(jids.tolist(), idx.tolist())]
        return ScheduleResult(
            assignment=assignment,
            est_start=est_start, est_finish=est_finish,
            est_makespan=float(est_finish.max(initial=0.0)),
            theta=theta, kappa=kappa, policy=policy,
            max_busy_time=float(self.U[row].max(initial=0.0)))
