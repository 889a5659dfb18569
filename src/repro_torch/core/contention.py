"""The paper's analytical model: Eqs. (6)-(8), vectorised over jobs.

Given a placement matrix Y[t] (rows = active jobs, cols = servers, entries =
#GPUs of that job on that server), compute

  p_j[t]   (Eq. 6)  largest #concurrent jobs sharing an inter-server link
  k_j[t]   (Eq. 7)  effective contention, k = xi1 * p (clamped >= 1)
  f(a, k)           bandwidth-sharing degradation, linear form k + a(k-1)
  B_j(y[t])         bottleneck bandwidth: b_i if single-server else b_e/f
  gamma_j           comm overhead, xi2 * #servers spanned
  tau_j[t] (Eq. 8)  per-iteration RAR time
  phi_j[t]          iterations completed per slot, floor(1/tau)

Three evaluation engines share these formulas (and are bit-identical):

  * :func:`evaluate` -- one placement [J, S], the reference path;
  * :func:`evaluate_many` -- a stack of C candidate placements [C, J, S]
    scored in a single vectorised pass (the straddle/per-server reductions
    are shared across candidates; no per-candidate Python loop);
  * :class:`IncrementalEval` -- maintains p/k/tau under single-row
    add/remove in O(S + |affected rows|) instead of recomputing all J rows,
    for hot loops (scheduler placement probes, the slot simulator) where
    the active set changes one job at a time.

Heterogeneous clusters (per-GPU ``gpu_speeds`` / per-server uplink
``links`` on :class:`~repro_torch.core.cluster.Cluster`) generalise B_j and the
reduction speed: a job's compute speed is the minimum server speed floor
over its occupied servers (Eq. (1) paces a ring at its slowest member),
and its inter-server bandwidth is ``min(min_iso_bw, min_shared_bw / f)``
-- isolated uplinks skip the Eq. (8) sharing divisor.  Every engine
derives these from the occupancy rows via :func:`_hetero_mins`, and the
degenerate case (uniform speeds, all-shared links) runs today's scalar
expressions bit-identically.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.cluster import Cluster
from repro_torch.core.jobs import Job

# --------------------------------------------------------------------------
# Engine selection
# --------------------------------------------------------------------------

ENGINES = ("incremental", "batched", "reference")

# Module-wide default used by PlacementState and the simulator when no
# explicit engine is requested.  "incremental" is the fast path;
# "reference" is the original per-candidate evaluate() loop kept for
# equivalence testing and as the semantics oracle.
DEFAULT_ENGINE = "incremental"

@contextlib.contextmanager
def evaluation_engine(name: str):
    """Temporarily set the module-wide default evaluation engine."""
    global DEFAULT_ENGINE
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}; choose from {ENGINES}")
    prev, DEFAULT_ENGINE = DEFAULT_ENGINE, name
    try:
        yield
    finally:
        DEFAULT_ENGINE = prev


def resolve_engine(name: str | None) -> str:
    """An explicit engine name, or the module-wide default."""
    if name is None:
        return DEFAULT_ENGINE
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}; choose from {ENGINES}")
    return name


# Backend for stack_model's inner tau reduction: "numpy" (default) or
# "kernel" (repro_torch.kernels.tau: the hand-written CUDA kernels on a
# CUDA device, their plain PyTorch versions on the CPU), on TAU_DEVICE.
TAU_BACKENDS = ("numpy", "kernel")
TAU_BACKEND = "numpy"
TAU_DEVICE = None


@contextlib.contextmanager
def tau_backend(name: str, device="cuda"):
    """Temporarily select the stack-model tau backend ("numpy"/"kernel")
    and, for "kernel", the device its tensors live on (resolved by
    :func:`repro_torch.resolve_device`, which raises when CUDA is asked
    for and absent)."""
    global TAU_BACKEND, TAU_DEVICE
    if name not in TAU_BACKENDS:
        raise ValueError(f"unknown tau backend {name!r}; "
                         f"choose from {TAU_BACKENDS}")
    dev = resolve_device(device) if name == "kernel" else None
    prev = TAU_BACKEND, TAU_DEVICE
    TAU_BACKEND, TAU_DEVICE = name, dev
    try:
        yield
    finally:
        TAU_BACKEND, TAU_DEVICE = prev


# --------------------------------------------------------------------------
# Model terms
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IterModel:
    """Per-slot evaluation of the Eq. (8) terms for a set of active jobs.

    Arrays are [J] from :func:`evaluate` / :meth:`IncrementalEval.model`,
    or [C, J] from :func:`evaluate_many` (leading candidate axis)."""

    p: np.ndarray          # Eq. (6), int
    k: np.ndarray          # Eq. (7), float
    bandwidth: np.ndarray  # B_j(y[t]), float
    gamma: np.ndarray      # comm overhead, float
    exchange: np.ndarray   # information-exchange term, float
    reduce: np.ndarray     # reduction-compute term, float
    compute: np.ndarray    # Delta_f * M + Delta_b, float
    tau: np.ndarray        # Eq. (8), float
    phi: np.ndarray        # iterations per slot, int


def degradation(alpha: float, k):
    """Bandwidth-sharing degradation factor f(alpha, k).

    Linear model from §4.1: f = k + alpha * (k - 1); f(alpha, 1) = 1 and
    increasing in k, as the paper requires.  Accepts scalars or arrays and
    returns a matching float / ndarray.
    """
    arr = np.maximum(np.asarray(k, dtype=np.float64), 1.0)
    out = arr + alpha * (arr - 1.0)
    if np.ndim(k) == 0:
        return float(out)
    return out


def contention_level(Y: np.ndarray, G: np.ndarray) -> np.ndarray:
    """p_j per Eq. (6).

    A job *straddles* server s iff 0 < y_js < G_j (it uses inter-server
    links through s).  p_j = max over straddled servers of the number of
    straddling jobs on that server (including j itself).
    """
    Y = np.asarray(Y)
    if Y.ndim != 2:
        raise ValueError("Y must be [J, S]")
    straddle = (Y > 0) & (Y < G[:, None])          # [J, S]
    per_server = straddle.sum(axis=0)              # [S], #contenders per server
    p = np.where(straddle, per_server[None, :], 0).max(axis=1)
    return p.astype(np.int64)


def _job_terms(jobs: list[Job]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Placement-independent per-job terms of Eq. (8): (G, share, compute)
    where share = m(w-1)/w is the per-GPU exchanged volume."""
    G = np.asarray([j.num_gpus for j in jobs], dtype=np.int64)
    m = np.asarray([j.grad_size for j in jobs], dtype=np.float64)
    w = G.astype(np.float64)
    M = np.asarray([j.batch for j in jobs], dtype=np.float64)
    dfw = np.asarray([j.dt_fwd for j in jobs], dtype=np.float64)
    dbw = np.asarray([j.dt_bwd for j in jobs], dtype=np.float64)
    # Eq. (8): single-GPU jobs (w=1) have no exchange/reduction terms.
    share = np.where(w > 1, (m / w) * (w - 1.0), 0.0)
    compute = dfw * M + dbw
    return G, share, compute


def _hetero_mins(cluster: Cluster, occupied: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Worst-member device terms per occupancy row.

    ``occupied`` is a bool mask [..., S]; returns ``(speed, bw_shared,
    bw_isolated)`` with the leading shape of ``occupied``: the slowest
    server speed floor, slowest shared uplink, and slowest isolated uplink
    over each row's occupied servers (+inf where a class is absent, so
    ``min(bw_isolated, bw_shared / f)`` and ``np.minimum`` select the real
    bottleneck).  Masked minima are pure selections, so the degenerate
    uniform cluster reproduces the scalar fields exactly."""
    speed = np.where(occupied, cluster.server_speed_floor, np.inf).min(axis=-1)
    bw_sh = np.where(occupied, cluster.uplink_shared_or_inf, np.inf).min(axis=-1)
    bw_iso = np.where(occupied, cluster.uplink_isolated_or_inf, np.inf).min(axis=-1)
    return speed, bw_sh, bw_iso


def evaluate(cluster: Cluster, jobs: list[Job], Y: np.ndarray) -> IterModel:
    """Evaluate Eqs. (6)-(8) for the active-job placement ``Y`` [J, S]."""
    J = len(jobs)
    if Y.shape != (J, cluster.num_servers):
        raise ValueError(f"Y shape {Y.shape} != ({J}, {cluster.num_servers})")
    G, share, compute = _job_terms(jobs)
    if not np.array_equal(Y.sum(axis=1), G):
        raise ValueError("placement does not cover every job's GPUs (Eq. 1)")

    p = contention_level(Y, G)
    k = np.maximum(cluster.xi1 * p, 1.0)
    multi = (Y > 0).sum(axis=1) > 1
    f = degradation(cluster.alpha, k)
    if cluster.is_heterogeneous:
        speed, bw_sh, bw_iso = _hetero_mins(cluster, Y > 0)
        bandwidth = np.where(multi, np.minimum(bw_iso, bw_sh / f),
                             cluster.b_intra)
    else:
        speed = cluster.gpu_speed
        bandwidth = np.where(multi, cluster.b_inter / f, cluster.b_intra)

    n_srv = (Y > 0).sum(axis=1).astype(np.float64)
    gamma = cluster.xi2 * n_srv

    exchange = 2.0 * share / bandwidth
    reduce_t = share / speed
    tau = exchange + reduce_t + gamma + compute
    phi = np.floor(1.0 / tau).astype(np.int64)
    return IterModel(p=p, k=k, bandwidth=bandwidth, gamma=gamma,
                     exchange=exchange, reduce=reduce_t, compute=compute,
                     tau=tau, phi=phi)


def stack_model(cluster: Cluster, G: np.ndarray, share: np.ndarray,
                compute: np.ndarray, Y_stack: np.ndarray,
                active: np.ndarray | None = None) -> IterModel:
    """Eqs. (6)-(8) on a prepared [C, J, S] candidate stack.

    The vectorised core shared by :func:`evaluate_many` (which adds Job
    -list handling and Eq. (1) validation on top), the simulator's
    multi-window stepping (which pre-computes the placement-independent
    terms ``G``/``share``/``compute`` once per run and feeds window
    stacks straight in), and :func:`evaluate_stack`.  The term arrays may
    be shared across candidates ([J], broadcast over the stack) or
    per-candidate ([C, J] -- the columnar placement engine's branch
    stacks, where each candidate row set comes from a different decision
    history); both shapes follow the same elementwise expressions, so the
    shared form is the per-candidate form with repeated rows.  ``active``
    [C, J] masks rows out per candidate by zeroing them -- a zero row
    straddles nothing, so every other row's contention is exactly as if
    the row were absent.

    When the tau kernel is enabled (see :func:`tau_backend`), the inner
    straddle/per-server/max reduction and the Eq. (8) combination run in
    :func:`repro_torch.kernels.tau.tau_stack` (one CUDA block per
    candidate) instead of this NumPy pipeline; p, n_srv and tau come from
    it, the other :class:`IterModel` fields stay host NumPy.
    """
    Y = Y_stack
    if active is not None:
        Y = np.where(active[:, :, None], Y, 0)
    G2 = np.broadcast_to(np.asarray(G), Y.shape[:2])
    share2 = np.broadcast_to(np.asarray(share), Y.shape[:2])
    compute2 = np.broadcast_to(np.asarray(compute), Y.shape[:2])
    if TAU_BACKEND != "numpy":
        from repro_torch.kernels.tau import tau_stack
        p, n_srv_i, tau = tau_stack(cluster, G, share, compute, Y,
                                    device=TAU_DEVICE)
    else:
        straddle = (Y > 0) & (Y < G2[:, :, None])      # [C, J, S]
        per_server = straddle.sum(axis=1)              # [C, S]
        p = np.where(straddle, per_server[:, None, :], 0).max(axis=2)
        p = p.astype(np.int64)
        n_srv_i = (Y > 0).sum(axis=2)
        tau = None                       # derived from the terms below
    k = np.maximum(cluster.xi1 * p, 1.0)
    f = degradation(cluster.alpha, k)
    if cluster.is_heterogeneous:
        speed, bw_sh, bw_iso = _hetero_mins(cluster, Y > 0)
        bandwidth = np.where(n_srv_i > 1, np.minimum(bw_iso, bw_sh / f),
                             cluster.b_intra)
    else:
        speed = cluster.gpu_speed
        bandwidth = np.where(n_srv_i > 1, cluster.b_inter / f, cluster.b_intra)
    gamma = cluster.xi2 * n_srv_i.astype(np.float64)
    exchange = 2.0 * share2 / bandwidth
    reduce_t = share2 / speed
    compute_b = compute2
    if tau is None:
        tau = exchange + reduce_t + gamma + compute_b
    phi = np.floor(1.0 / tau).astype(np.int64)
    return IterModel(p=p, k=k, bandwidth=bandwidth, gamma=gamma,
                     exchange=exchange, reduce=reduce_t, compute=compute_b,
                     tau=tau, phi=phi)


def ladder_terms(cluster: Cluster, jobs: list[Job], Y_rows: np.ndarray
                 ) -> dict[str, np.ndarray]:
    """Per-job arrays :func:`tau_ladder` needs, computed once per run.

    ``Y_rows`` [J, S] holds each job's per-server GPU counts.  Everything
    here is stage-independent: the straddle vectors (Eq. 6), whether a
    job spans servers, and the share/reduce/gamma/compute terms of
    Eq. (8).  :func:`tau_ladder` gathers rows of these by job id."""
    G, share, compute = _job_terms(jobs)
    straddle = (Y_rows > 0) & (Y_rows < G[:, None])
    n_srv = (Y_rows > 0).sum(axis=1)
    if cluster.is_heterogeneous:
        speed, bw_sh, bw_iso = _hetero_mins(cluster, Y_rows > 0)
        reduce_t = share / speed
    else:
        reduce_t = share / cluster.gpu_speed
        bw_sh = np.full(len(jobs), float(cluster.b_inter))
        bw_iso = np.full(len(jobs), np.inf)
    return {
        "straddle": straddle,
        "multi": n_srv > 1,
        "share": share,
        "reduce": reduce_t,
        "bw_sh": bw_sh,
        "bw_iso": bw_iso,
        "gamma": cluster.xi2 * n_srv.astype(np.float64),
        "compute": compute,
    }


def tau_ladder(cluster: Cluster, terms: dict[str, np.ndarray],
               rows: np.ndarray, depth: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched Eq. (6)-(8) maintenance for a removal ladder.

    ``rows`` holds the active job ids in guessed completion order; stage
    ``s`` is the active set with the first ``s`` rows removed.  Removing
    a row only subtracts its straddle vector from the per-server Eq. (6)
    counts, so all ``depth + 1`` stages' counts come from one cumulative
    sum -- the vectorised form of :class:`IncrementalEval`'s per-row
    remove maintenance -- and one [depth+1, A, S] max produces every
    stage's p.  ``terms`` is the run-constant bundle from
    :func:`ladder_terms`.  Returns (p, tau, phi), each [depth+1, A];
    entries for already-removed rows are meaningless and must not be
    read.  Values are bit-identical to :func:`evaluate` on each stage's
    surviving subset (same integer counts, same float expression order).
    """
    straddle = terms["straddle"][rows]                 # [A, S]
    total = straddle.sum(axis=0)                       # [S]
    if depth:
        drops = np.cumsum(straddle[:depth], axis=0)    # [depth, S]
        per_server = np.concatenate([total[None], total[None] - drops])
    else:
        per_server = total[None]
    p = (straddle[None, :, :] * per_server[:, None, :]).max(axis=2)
    k = np.maximum(cluster.xi1 * p, 1.0)
    f = k + cluster.alpha * (k - 1.0)    # degradation(); k already >= 1
    # bw_sh is filled with b_inter (bw_iso with +inf) on homogeneous
    # clusters, so this is the same elementwise division as the scalar
    # form there and the isolated-uplink minimum elsewhere.
    bandwidth = np.where(terms["multi"][rows][None, :],
                         np.minimum(terms["bw_iso"][rows][None, :],
                                    terms["bw_sh"][rows][None, :] / f),
                         cluster.b_intra)
    exchange = 2.0 * terms["share"][rows][None, :] / bandwidth
    tau = exchange + terms["reduce"][rows][None, :] \
        + terms["gamma"][rows][None, :] + terms["compute"][rows][None, :]
    phi = np.floor(1.0 / tau).astype(np.int64)
    return p, tau, phi


def evaluate_many(cluster: Cluster, jobs: list[Job], Y_stack: np.ndarray,
                  active: np.ndarray | None = None) -> IterModel:
    """Score a stack of C candidate placements [C, J, S] in one pass.

    ``jobs`` is the shared row order across candidates.  ``active`` [C, J]
    (optional) marks which rows participate in each candidate; inactive
    rows are zeroed out, which leaves every other row's contention exactly
    as if the row were absent (a zero row straddles nothing), so candidates
    with different overlap subsets of the same job list can share a stack.

    Bit-identical to running :func:`evaluate` per candidate: all reductions
    run along the same axes with the same element values.  Inactive rows
    still receive (meaningless) tau entries -- callers must only read
    active rows.
    """
    Y = np.asarray(Y_stack)
    if Y.ndim != 3 or Y.shape[1:] != (len(jobs), cluster.num_servers):
        raise ValueError(
            f"Y_stack shape {Y.shape} != (C, {len(jobs)}, {cluster.num_servers})")
    G, share, compute = _job_terms(jobs)
    if active is not None:
        active = np.asarray(active, dtype=bool)
        if active.shape != Y.shape[:2]:
            raise ValueError(f"active shape {active.shape} != {Y.shape[:2]}")
        Y = np.where(active[:, :, None], Y, 0)
        expect = np.where(active, G[None, :], 0)
    else:
        expect = np.broadcast_to(G[None, :], Y.shape[:2])
    if not np.array_equal(Y.sum(axis=2), expect):
        raise ValueError("placement does not cover every job's GPUs (Eq. 1)")

    return stack_model(cluster, G, share, compute, Y)


def evaluate_stack(cluster: Cluster, G: np.ndarray, share: np.ndarray,
                   compute: np.ndarray, Y_stack: np.ndarray,
                   active: np.ndarray | None = None) -> IterModel:
    """Score a padded candidate stack whose rows differ *per candidate*.

    The columnar-stack entry point: where :func:`evaluate_many` shares one
    job list (and hence one [J] term vector) across all candidates, here
    each candidate carries its own row set -- ``G``/``share``/``compute``
    are [C, J] with candidate c's row j holding the Eq. (8) terms of
    whatever job occupies that slot of c's stack (zero-padded, inactive
    rows beyond c's depth).  This is how the columnar placement engine
    scores one probe per *branch row* in a single pass without gathering
    the branches onto a shared job order.  Shared [J] terms are accepted
    too and broadcast, making :func:`evaluate_many` the special case.

    Same Eq. (1) validation, counters, and :func:`stack_model` core as
    :func:`evaluate_many`; bit-identical to evaluating each candidate's
    active rows with :func:`evaluate`.
    """
    Y = np.asarray(Y_stack)
    if Y.ndim != 3 or Y.shape[2] != cluster.num_servers:
        raise ValueError(
            f"Y_stack shape {Y.shape} != (C, J, {cluster.num_servers})")
    G2 = np.broadcast_to(np.asarray(G), Y.shape[:2])
    if active is not None:
        active = np.asarray(active, dtype=bool)
        if active.shape != Y.shape[:2]:
            raise ValueError(f"active shape {active.shape} != {Y.shape[:2]}")
        Y = np.where(active[:, :, None], Y, 0)
        expect = np.where(active, G2, 0)
    else:
        expect = G2
    if not np.array_equal(Y.sum(axis=2), expect):
        raise ValueError("placement does not cover every job's GPUs (Eq. 1)")

    return stack_model(cluster, G, share, compute, Y)


# --------------------------------------------------------------------------
# Incremental engine
# --------------------------------------------------------------------------


class IncrementalEval:
    """Exact Eq. (6)-(8) maintenance under single-row placement changes.

    Holds the straddle matrix and the per-server straddler counts for a
    live set of rows.  :meth:`add` / :meth:`remove` update the counts for
    the one changed row and recompute p (and, where p changed, k/B/tau/phi)
    only for the rows straddling a server whose count moved -- O(S +
    |affected|) per update instead of the O(J*S) of a fresh
    :func:`evaluate`.  All terms are computed with the same expressions as
    :func:`evaluate`, so the maintained state is bit-identical.
    """

    def __init__(self, cluster: Cluster, capacity: int = 16):
        self.cluster = cluster
        self._S = cluster.num_servers
        cap = max(4, capacity)
        self._jobs: list[Job | None] = [None] * cap
        self._live = np.zeros(cap, dtype=bool)
        self._Y = np.zeros((cap, self._S), dtype=np.int64)
        self._straddle = np.zeros((cap, self._S), dtype=bool)
        self._per_server = np.zeros(self._S, dtype=np.int64)
        # Placement-independent per-row terms (cached at add).
        self._share = np.zeros(cap)
        self._reduce = np.zeros(cap)
        self._compute = np.zeros(cap)
        # Device terms over the row's occupied servers (cached at add;
        # constants gpu_speed / b_inter / +inf on homogeneous clusters).
        self._spd = np.zeros(cap)
        self._bw_sh = np.zeros(cap)
        self._bw_iso = np.zeros(cap)
        # Placement-dependent but row-local terms.
        self._gamma = np.zeros(cap)
        self._multi = np.zeros(cap, dtype=bool)
        # Contention-dependent terms, maintained incrementally.
        self._p = np.zeros(cap, dtype=np.int64)
        self._k = np.zeros(cap)
        self._bandwidth = np.zeros(cap)
        self._exchange = np.zeros(cap)
        self._tau = np.zeros(cap)
        self._phi = np.zeros(cap, dtype=np.int64)
        self._free = list(range(cap))

    def __len__(self) -> int:
        return int(self._live.sum())

    def _grow(self) -> None:
        cap = len(self._live)
        new = cap * 2
        self._jobs.extend([None] * cap)
        for name in ("_live", "_share", "_reduce", "_compute", "_spd",
                     "_bw_sh", "_bw_iso", "_gamma", "_multi", "_p", "_k",
                     "_bandwidth", "_exchange", "_tau", "_phi"):
            old = getattr(self, name)
            setattr(self, name, np.concatenate(
                [old, np.zeros(cap, dtype=old.dtype)]))
        self._Y = np.concatenate(
            [self._Y, np.zeros((cap, self._S), dtype=np.int64)])
        self._straddle = np.concatenate(
            [self._straddle, np.zeros((cap, self._S), dtype=bool)])
        self._free.extend(range(cap, new))

    def add(self, job: Job, y: np.ndarray) -> int:
        """Insert a placed job row ``y`` [S]; returns its row handle."""
        y = np.asarray(y, dtype=np.int64)
        if y.shape != (self._S,):
            raise ValueError(f"y shape {y.shape} != ({self._S},)")
        if int(y.sum()) != job.num_gpus:
            raise ValueError("placement does not cover the job's GPUs (Eq. 1)")
        if not self._free:
            self._grow()
        row = self._free.pop()
        cl = self.cluster
        self._jobs[row] = job
        self._Y[row] = y
        w = float(job.num_gpus)
        share = (job.grad_size / w) * (w - 1.0) if w > 1 else 0.0
        pos = y > 0
        if cl.is_heterogeneous:
            spd = float(cl.server_speed_floor[pos].min())
            bw_sh = float(cl.uplink_shared_or_inf[pos].min())
            bw_iso = float(cl.uplink_isolated_or_inf[pos].min())
        else:
            spd, bw_sh, bw_iso = cl.gpu_speed, cl.b_inter, np.inf
        self._spd[row] = spd
        self._bw_sh[row] = bw_sh
        self._bw_iso[row] = bw_iso
        self._share[row] = share
        self._reduce[row] = share / spd
        self._compute[row] = job.dt_fwd * float(job.batch) + job.dt_bwd
        n_srv = int(pos.sum())
        self._gamma[row] = cl.xi2 * float(n_srv)
        self._multi[row] = n_srv > 1
        row_straddle = pos & (y < job.num_gpus)
        self._straddle[row] = row_straddle
        self._live[row] = True
        self._apply_count_delta(row, row_straddle, +1)
        return row

    def remove(self, row: int) -> None:
        """Remove a previously added row; its handle becomes invalid."""
        if not self._live[row]:
            raise KeyError(f"row {row} is not live")
        row_straddle = self._straddle[row].copy()
        self._live[row] = False
        self._straddle[row] = False
        self._Y[row] = 0
        self._jobs[row] = None
        self._apply_count_delta(row, row_straddle, -1)
        self._free.append(row)

    def _refresh_terms_scalar(self, r: int) -> None:
        """Recompute k/B/exchange/tau/phi for one row from its current p.
        Plain float64 arithmetic with the same operation order as the
        vector path, so bit-identical results."""
        cl = self.cluster
        k = cl.xi1 * float(self._p[r])
        if k < 1.0:
            k = 1.0
        f = k + cl.alpha * (k - 1.0)
        if self._multi[r]:
            # _bw_sh/_bw_iso cache b_inter/+inf on homogeneous clusters,
            # so this is the original b_inter / f there.
            bandwidth = float(self._bw_sh[r]) / f
            bw_iso = float(self._bw_iso[r])
            if bw_iso < bandwidth:
                bandwidth = bw_iso
        else:
            bandwidth = cl.b_intra
        exchange = 2.0 * float(self._share[r]) / bandwidth
        tau = exchange + float(self._reduce[r]) \
            + float(self._gamma[r]) + float(self._compute[r])
        self._k[r] = k
        self._bandwidth[r] = bandwidth
        self._exchange[r] = exchange
        self._tau[r] = tau
        self._phi[r] = math.floor(1.0 / tau)

    def _refresh_terms(self, upd: np.ndarray) -> None:
        """Recompute k/B/exchange/tau/phi for the rows whose p changed."""
        if len(upd) == 1:
            self._refresh_terms_scalar(int(upd[0]))
            return
        cl = self.cluster
        k = np.maximum(cl.xi1 * self._p[upd], 1.0)
        f = degradation(cl.alpha, k)
        bandwidth = np.where(self._multi[upd],
                             np.minimum(self._bw_iso[upd],
                                        self._bw_sh[upd] / f),
                             cl.b_intra)
        exchange = 2.0 * self._share[upd] / bandwidth
        tau = exchange + self._reduce[upd] + self._gamma[upd] + self._compute[upd]
        self._k[upd] = k
        self._bandwidth[upd] = bandwidth
        self._exchange[upd] = exchange
        self._tau[upd] = tau
        self._phi[upd] = np.floor(1.0 / tau).astype(np.int64)

    def _apply_count_delta(self, row: int, row_straddle: np.ndarray,
                           delta: int) -> None:
        # Contention moves monotonically with the per-server counts, so
        # other rows never need a full O(S) p recompute on add (their p can
        # only grow, and only through a changed server: an O(|changed|) max
        # suffices), and on remove only rows whose old p sat exactly on a
        # changed server's old count can shrink.
        changed = np.flatnonzero(row_straddle)
        n_changed = len(changed)
        counts_c = None
        if n_changed:
            self._per_server[changed] += delta
            counts_c = self._per_server[changed]
            affected = self._live & self._straddle[:, changed].any(axis=1)
            affected[row] = False       # the changed row is handled below
            rows = np.flatnonzero(affected)
        else:
            rows = ()
        if len(rows):
            if n_changed == 1:
                # Every affected row straddles the single changed server.
                cand = counts_c[0]
            else:
                cand = (self._straddle[np.ix_(rows, changed)]
                        * counts_c).max(axis=1)
            if delta > 0:
                grew = cand > self._p[rows]
                upd = rows[grew]
                if len(upd):
                    self._p[upd] = cand[grew] if n_changed > 1 else cand
                    self._refresh_terms(upd)
            else:
                # Old count at a changed server = new count + 1; rows whose
                # p exceeds every changed server's old count peak elsewhere.
                maybe = rows[self._p[rows] == cand + 1]
                if len(maybe):
                    p_new = (self._straddle[maybe]
                             * self._per_server).max(axis=1)
                    shrunk = p_new != self._p[maybe]
                    upd = maybe[shrunk]
                    if len(upd):
                        self._p[upd] = p_new[shrunk]
                        self._refresh_terms(upd)
        if delta > 0:
            # The new row always needs its own full terms; its straddled
            # servers are exactly ``changed``, so its Eq. (6) level is the
            # max of their (fresh) counts.
            self._p[row] = int(counts_c.max()) if n_changed else 0
            self._refresh_terms_scalar(row)

    def tau_of(self, row: int) -> float:
        """Current Eq. (8) tau of a live row."""
        if not self._live[row]:
            raise KeyError(f"row {row} is not live")
        return float(self._tau[row])

    def probe_tau(self, job: Job, y: np.ndarray) -> float:
        """tau of ``job`` if placed as ``y`` against the current live set,
        WITHOUT mutating any state.  tau_j depends only on the job's own
        contention level p_j = max over its straddled servers of the
        straddler count including itself (Eq. 6) -- other rows' p values
        don't enter Eq. (8) for j -- so a probe is a pure O(S) read."""
        y = np.asarray(y, dtype=np.int64)
        if int(y.sum()) != job.num_gpus:
            raise ValueError("placement does not cover the job's GPUs (Eq. 1)")
        straddle_row = (y > 0) & (y < job.num_gpus)
        p = int((self._per_server[straddle_row] + 1).max()) \
            if straddle_row.any() else 0
        n_srv = int((y > 0).sum())
        cl = self.cluster
        if cl.is_heterogeneous:
            pos = y > 0
            return scalar_tau(
                cl, job, p, n_srv,
                speed=float(cl.server_speed_floor[pos].min()),
                bw_shared=float(cl.uplink_shared_or_inf[pos].min()),
                bw_isolated=float(cl.uplink_isolated_or_inf[pos].min()))
        return scalar_tau(cl, job, p, n_srv)

    def probe_tau_many(self, job: Job, Y_stack: np.ndarray) -> np.ndarray:
        """Batched :meth:`probe_tau`: tau of ``job`` for each candidate
        placement row of ``Y_stack`` [C, S], scored against the current
        live set in one vectorised pass (no per-candidate Python loop) and
        without mutating any state.  Bit-identical to C scalar probes."""
        Y = np.asarray(Y_stack, dtype=np.int64)
        if Y.ndim != 2 or Y.shape[1] != self._S:
            raise ValueError(f"Y_stack shape {Y.shape} != (C, {self._S})")
        if not np.all(Y.sum(axis=1) == job.num_gpus):
            raise ValueError("placement does not cover the job's GPUs (Eq. 1)")
        straddle = (Y > 0) & (Y < job.num_gpus)              # [C, S]
        p = np.where(straddle, (self._per_server + 1)[None, :], 0).max(axis=1)
        n_srv = (Y > 0).sum(axis=1)
        cl = self.cluster
        if cl.is_heterogeneous:
            speed, bw_sh, bw_iso = _hetero_mins(cl, Y > 0)
            return scalar_tau_many(cl, job, p, n_srv, speed=speed,
                                   bw_shared=bw_sh, bw_isolated=bw_iso)
        return scalar_tau_many(cl, job, p, n_srv)

    def window(self, rows) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(p, tau, phi) for live ``rows`` -- the simulator's per-window
        gather.  Fancy indexing already copies, so this is three array
        gathers instead of :meth:`model`'s nine."""
        idx = np.asarray(rows, dtype=np.int64)
        if idx.ndim != 1 or (len(idx) and not np.all(self._live[idx])):
            raise KeyError("window() requires live row handles")
        return self._p[idx], self._tau[idx], self._phi[idx]

    def model(self, rows) -> IterModel:
        """Gather the maintained terms for ``rows`` (in that order)."""
        idx = np.asarray(rows, dtype=np.int64)
        if idx.ndim != 1 or (len(idx) and not np.all(self._live[idx])):
            raise KeyError("model() requires live row handles")
        return IterModel(
            p=self._p[idx].copy(), k=self._k[idx].copy(),
            bandwidth=self._bandwidth[idx].copy(),
            gamma=self._gamma[idx].copy(),
            exchange=self._exchange[idx].copy(),
            reduce=self._reduce[idx].copy(),
            compute=self._compute[idx].copy(),
            tau=self._tau[idx].copy(), phi=self._phi[idx].copy())


# --------------------------------------------------------------------------
# Estimate helpers (shared by every rho-hat consumer)
# --------------------------------------------------------------------------


def scalar_tau(cluster: Cluster, job: Job, p: int, n_srv: int,
               speed: float | None = None, bw_shared: float | None = None,
               bw_isolated: float | None = None) -> float:
    """Eq. (8) for one job given its contention level ``p`` and server
    spread ``n_srv`` -- the scalar core shared by the incremental probes.
    Plain-float IEEE arithmetic (Python floats are IEEE float64, so the
    inlined degradation is the same computation), bit-identical to the
    vectorised engines.

    ``speed``/``bw_shared``/``bw_isolated`` carry the heterogeneous
    worst-member device terms over the candidate's occupied servers (see
    :func:`_hetero_mins`); ``None`` keeps the uniform scalars (the
    homogeneous original, expression for expression).
    """
    w = float(job.num_gpus)
    share = (job.grad_size / w) * (w - 1.0) if w > 1 else 0.0
    k = max(cluster.xi1 * p, 1.0)
    if n_srv > 1:
        sh = cluster.b_inter if bw_shared is None else bw_shared
        bandwidth = sh / (k + cluster.alpha * (k - 1.0))
        if bw_isolated is not None and bw_isolated < bandwidth:
            bandwidth = bw_isolated
    else:
        bandwidth = cluster.b_intra
    gamma = cluster.xi2 * float(n_srv)
    exchange = 2.0 * share / bandwidth
    reduce_t = share / (cluster.gpu_speed if speed is None else speed)
    compute = job.dt_fwd * float(job.batch) + job.dt_bwd
    return exchange + reduce_t + gamma + compute


def scalar_tau_many(cluster: Cluster, job: Job, p: np.ndarray,
                    n_srv: np.ndarray, speed: np.ndarray | None = None,
                    bw_shared: np.ndarray | None = None,
                    bw_isolated: np.ndarray | None = None) -> np.ndarray:
    """Batched :func:`scalar_tau`: Eq. (8) for one job at C hypothesised
    (contention level, server spread) pairs in one vectorised pass -- the
    batched probe entry point shared by :meth:`IncrementalEval.probe_tau_many`
    and the scheduler's multi-candidate rho-hat probes
    (:meth:`repro_torch.core.api.PlacementState.refined_rho_many`).  Elementwise
    float64 with the same operation order as the scalar form, so the
    results are bit-identical per candidate.  The optional
    ``speed``/``bw_shared``/``bw_isolated`` arrays ([C], from
    :func:`_hetero_mins`) carry per-candidate heterogeneous device terms;
    ``None`` keeps the uniform scalars.

    The columnar score kernel (``score_probes`` in
    :mod:`repro_torch.kernels.placement`) re-derives exactly this
    expression chain on the device -- any change to the operation order
    here must land there too, or the float64 bit-identity with the
    reference breaks."""
    p = np.asarray(p, dtype=np.float64)
    n_srv = np.asarray(n_srv)
    w = float(job.num_gpus)
    share = (job.grad_size / w) * (w - 1.0) if w > 1 else 0.0
    k = np.maximum(cluster.xi1 * p, 1.0)
    f = degradation(cluster.alpha, k)
    sh = cluster.b_inter if bw_shared is None \
        else np.asarray(bw_shared, dtype=np.float64)
    bw_multi = sh / f
    if bw_isolated is not None:
        bw_multi = np.minimum(np.asarray(bw_isolated, dtype=np.float64),
                              bw_multi)
    bandwidth = np.where(n_srv > 1, bw_multi, cluster.b_intra)
    gamma = cluster.xi2 * n_srv.astype(np.float64)
    exchange = 2.0 * share / bandwidth
    reduce_t = share / (cluster.gpu_speed if speed is None
                        else np.asarray(speed, dtype=np.float64))
    compute = job.dt_fwd * float(job.batch) + job.dt_bwd
    return exchange + reduce_t + gamma + compute


def slots_for(iters: int, tau: float) -> float:
    """rho-hat slot count at per-iteration time ``tau``: ceil(F_j / phi)
    with phi = floor(1/tau) clamped >= 1.  The one place this floor/ceil
    pair lives -- PlacementState.refined_rho, estimate_exec_time and the
    Table-1 estimates all route through it.  (math.floor/ceil on floats
    match np.floor/ceil exactly; this is just the scalar fast path.)"""
    phi = max(1, math.floor(1.0 / tau))
    return float(math.ceil(iters / phi))


def slots_for_many(iters: int, tau: np.ndarray) -> np.ndarray:
    """Vectorised :func:`slots_for`: rho-hat slot counts for a batch of
    taus in one pass.  np.floor/np.ceil on float64 match math.floor/ceil
    exactly, phi is a small exact integer in float64, and int/int true
    division equals float64 division for exactly representable operands --
    so every element is bit-identical to the scalar form.  The columnar
    placement engine's per-step probe batches route through this."""
    phi = np.maximum(1.0, np.floor(1.0 / np.asarray(tau, dtype=np.float64)))
    return np.ceil(iters / phi)


def predict_exec_time(cluster: Cluster, job: Job, jobs_snapshot: list[Job],
                      Y_snapshot: np.ndarray, y_j: np.ndarray) -> float:
    """rho_hat(y^k): estimated execution time (slots) of ``job`` placed as
    ``y_j`` [S] while ``jobs_snapshot`` are placed as ``Y_snapshot``
    [J', S] -- the scheduler-side estimate of Fig. 3 (evaluate Eq. (8)
    against the snapshot, convert tau to slots, multiply by F_j)."""
    y_j = np.asarray(y_j)
    if len(jobs_snapshot):
        Y = np.vstack([np.asarray(Y_snapshot), y_j[None, :]])
    else:
        Y = y_j[None, :]
    model = evaluate(cluster, list(jobs_snapshot) + [job], Y)
    return slots_for(job.iters, float(model.tau[-1]))


def estimate_exec_time(cluster: Cluster, job: Job, Y_snapshot: np.ndarray,
                       jobs_snapshot: list[Job], y_j: np.ndarray) -> float:
    """Back-compat wrapper for :func:`predict_exec_time` (older argument
    order).  The true rho is later produced by the slot simulator
    (contention evolves over time)."""
    return predict_exec_time(cluster, job, jobs_snapshot, Y_snapshot, y_j)


def tau_bounds(cluster: Cluster, job: Job) -> tuple[float, float]:
    """[tau_lo, tau_hi] per §5.1: B in [b_e/f(a, max_s O_s), b_i], spread in
    [1, G_j] servers.  Used to derive the l/u estimate bracket.

    On heterogeneous clusters the bracket widens to the device extremes:
    tau_lo prices the fastest server speed floor, tau_hi the slowest floor
    and the worst effective uplink (isolated uplinks keep their full
    bandwidth; shared ones pay f(alpha, k_max))."""
    w = float(job.num_gpus)
    share = (job.grad_size / w) * (w - 1.0) if w > 1 else 0.0
    compute = job.dt_fwd * job.batch + job.dt_bwd
    k_max = max(1.0, cluster.xi1 * max(cluster.capacities))
    if cluster.is_heterogeneous:
        f_max = degradation(cluster.alpha, k_max)
        eff = np.where(cluster.uplink_isolated, cluster.uplink_bandwidth,
                       cluster.uplink_bandwidth / f_max)
        b_lo = float(eff.min())
        speed_hi = float(cluster.server_speed_floor.max())
        speed_lo = float(cluster.server_speed_floor.min())
    else:
        b_lo = cluster.b_inter / degradation(cluster.alpha, k_max)
        speed_hi = speed_lo = cluster.gpu_speed
    tau_lo = 2.0 * share / cluster.b_intra + share / speed_hi \
        + cluster.xi2 * 1.0 + compute
    tau_hi = 2.0 * share / b_lo + share / speed_lo \
        + cluster.xi2 * min(w, cluster.num_servers) + compute
    return tau_lo, tau_hi
