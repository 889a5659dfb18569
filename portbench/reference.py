"""Plain NumPy reference of the scheduler the benchmark drives.

A straightforward implementation of the semantics the program documents,
written from the paper (Yu et al., MobiHoc '22) and nothing of the
program: it imports neither the program nor the JAX package.

  * Eqs. (6)-(8): a job straddles a server when it holds some but not all
    of its GPUs there; its contention level p is the largest number of
    straddling jobs on a server it straddles; k = max(xi1 p, 1),
    f = k + alpha (k - 1); tau = 2 share / B + share / C + xi2 n_srv +
    (dt_fwd M + dt_bwd), with B = b_inter / f across servers and b_intra
    within one; a job's slots at tau are ceil(F / max(1, floor(1 / tau))).
  * Algorithm 1 (SJF-BCO): bisection on the busy-time budget theta in
    [1, horizon], each theta tried at every kappa; jobs in
    (G, id) order, G <= kappa by FA-FFP (Alg. 2) and the rest by LBSGF
    (Alg. 3), each pick priced against the placed jobs still running at
    its start and re-checked against theta (Eqs. 15-16), up to four tries.
  * The online rule of the scheduler daemon: jobs in (arrival, G, id)
    order, both pickers tried, the one that finishes first committed.
  * The slot simulator: each GPU serves its placements first come first
    served; a job starts once it heads every queue of its GPUs and has
    arrived, and runs floor(1 / tau) iterations a slot while the set of
    running jobs, and so tau, stays the same.

``F`` is the floating type of every computed number: ``np.float64``, the
precision the configurations state, or ``np.float32`` for the control
that a sound comparison has to fail.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

EPS = 1e-9


@dataclasses.dataclass
class Cluster:
    """Servers' GPU counts and the contention model's constants, in ``F``."""

    caps: np.ndarray
    F: type
    b_intra: float
    b_inter: float
    gpu_speed: float
    xi1: float
    xi2: float
    alpha: float

    @classmethod
    def make(cls, capacities, constants: dict, F=np.float64) -> "Cluster":
        return cls(np.asarray(capacities, dtype=np.int64), F,
                   *(F(constants[k]) for k in ("b_intra", "b_inter",
                                               "gpu_speed", "xi1", "xi2",
                                               "alpha")))

    def __post_init__(self):
        self.S = len(self.caps)
        self.N = int(self.caps.sum())
        # Server of each GPU id (servers hold contiguous id ranges).
        self.server = np.repeat(np.arange(self.S), self.caps)
        # lane i of server s is GPU first[s] + i, or N (a zero) past it.
        first = np.concatenate([[0], np.cumsum(self.caps)[:-1]])
        lane = np.arange(int(self.caps.max()))[:, None]
        self.lanes = np.where(lane < self.caps, first + lane, self.N)

    def per_server(self, gpus) -> np.ndarray:
        """GPUs of ``gpus`` on each server."""
        return np.bincount(self.server[np.asarray(gpus, dtype=np.int64)],
                           minlength=self.S)

    def server_sums(self, U: np.ndarray) -> np.ndarray:
        """Each server's clocks added one by one in GPU-id order."""
        return np.cumsum(np.append(U, U.dtype.type(0.0))[self.lanes],
                         axis=0)[-1]


def share_of(cl: Cluster, job) -> float:
    """Per-GPU exchanged volume m (w - 1) / w; nothing for one GPU."""
    F = cl.F
    if job.num_gpus <= 1:
        return F(0.0)
    w = F(job.num_gpus)
    return (F(job.grad_size) / w) * (w - F(1.0))


def compute_of(cl: Cluster, job) -> float:
    F = cl.F
    return F(job.dt_fwd) * F(job.batch) + F(job.dt_bwd)


def tau(cl: Cluster, job, p: int, n_srv: int) -> float:
    """Eq. (8) at contention level ``p`` over ``n_srv`` servers."""
    F = cl.F
    k = max(cl.xi1 * F(p), F(1.0))
    bw = cl.b_inter / (k + cl.alpha * (k - F(1.0))) if n_srv > 1 \
        else cl.b_intra
    share = share_of(cl, job)
    return F(2.0) * share / bw + share / cl.gpu_speed + cl.xi2 * F(n_srv) \
        + compute_of(cl, job)


def slots(cl: Cluster, iters: int, t: float) -> float:
    """Slots of ``iters`` iterations at ``t`` slots an iteration."""
    F = cl.F
    phi = max(1, math.floor(F(1.0) / t))
    return F(math.ceil(F(iters) / F(phi)))


def nominal_rho(cl: Cluster, job) -> float:
    """The contention-free lower estimate: tau within one server."""
    F = cl.F
    share = share_of(cl, job)
    t = F(2.0) * share / cl.b_intra + share / cl.gpu_speed \
        + cl.xi2 * F(1.0) + compute_of(cl, job)
    return slots(cl, job.iters, t)


def contention(Y: np.ndarray, G: np.ndarray) -> np.ndarray:
    """Eq. (6) of each row of the placement ``Y`` [J, S]."""
    straddle = (Y > 0) & (Y < G[:, None])
    per_server = straddle.sum(axis=0)
    return np.where(straddle, per_server[None, :], 0).max(axis=1,
                                                          initial=0)


class State:
    """One placement attempt: busy-time clocks U (Eq. 15), real-time
    clocks R, and the placed jobs (per-server counts, width, finish)."""

    def __init__(self, cl: Cluster, u: float, n: int):
        self.cl, self.u = cl, cl.F(u)
        self.U = np.zeros(cl.N, dtype=cl.F)
        self.R = np.zeros(cl.N, dtype=cl.F)
        # Placed rows, and one more for the candidate being priced.
        self.Y = np.zeros((n + 1, cl.S), dtype=np.int64)
        self.G = np.zeros(n + 1, dtype=np.int64)
        self.fin = np.zeros(n + 1, dtype=cl.F)
        self.P = 0
        self.assignment: list[tuple[int, np.ndarray]] = []
        self.start: dict[int, float] = {}
        self.rho: dict[int, float] = {}

    def copy(self) -> "State":
        new = State.__new__(State)
        new.cl, new.u, new.P = self.cl, self.u, self.P
        for name in ("U", "R", "Y", "G", "fin"):
            setattr(new, name, getattr(self, name).copy())
        new.assignment = list(self.assignment)
        new.start, new.rho = dict(self.start), dict(self.rho)
        return new

    def feasible(self, rho: float, theta: float) -> np.ndarray:
        """Eq. (16) pool: GPUs whose clock stays within theta."""
        F = self.cl.F
        return np.flatnonzero(self.U + rho / self.u <= theta + F(EPS))

    def price(self, job, gpus: np.ndarray) -> tuple[float, float]:
        """(slots, start) of ``job`` on ``gpus``: Eq. (8) against the
        placed jobs still running when all its GPUs are free."""
        F = self.cl.F
        start = self.R[gpus].max()
        y = self.cl.per_server(gpus)
        P = self.P
        self.Y[P], self.G[P], self.fin[P] = y, job.num_gpus, np.inf
        rows = self.fin[:P + 1] > start + F(EPS)
        p = int(contention(self.Y[:P + 1][rows], self.G[:P + 1][rows])[-1])
        return slots(self.cl, job.iters,
                     tau(self.cl, job, p, int((y > 0).sum()))), start

    def fits(self, gpus, rho, theta) -> bool:
        F = self.cl.F
        return bool(self.U[gpus].max() + rho / self.u <= theta + F(EPS))

    def commit(self, jid: int, job, gpus, rho, start) -> None:
        self.U[gpus] = self.U[gpus] + rho / self.u
        self.R[gpus] = start + rho
        P = self.P
        self.Y[P], self.G[P], self.fin[P] = self.cl.per_server(gpus), \
            job.num_gpus, start + rho
        self.P = P + 1
        self.assignment.append((jid, np.asarray(gpus, dtype=np.int64)))
        self.start[jid], self.rho[jid] = start, rho


def fa_ffp(st: State, job, rho: float, theta: float):
    """Alg. 2: the feasible GPUs of the best-fitting server (fewest
    feasible slots left, then most busy time, then lowest id), least busy
    first; without a fitting server the least busy feasible GPUs."""
    cl, G = st.cl, job.num_gpus
    pool = st.feasible(rho, theta)
    if len(pool) < G:
        return None
    cnt = np.bincount(cl.server[pool], minlength=cl.S)
    fits = [s for s in range(cl.S) if cnt[s] >= G]
    if fits:
        load = cl.server_sums(st.U)
        best = min(fits, key=lambda s: (cnt[s] - G, -load[s], s))
        pool = pool[cl.server[pool] == best]
    return pool[np.lexsort((pool, st.U[pool]))][:G]


def lbsgf(st: State, job, rho: float, theta: float):
    """Alg. 3: the least busy servers (by mean clock, lowest id first)
    whose capacity reaches lambda G; their feasible GPUs server by server,
    least busy first."""
    cl, G = st.cl, job.num_gpus
    load = cl.server_sums(st.U) / cl.caps.astype(cl.F)
    order = np.lexsort((np.arange(cl.S), load))
    need = cl.F(job.lam) * cl.F(G)
    m = min(int((np.cumsum(cl.caps[order]) < need).sum()) + 1, cl.S)
    rank = np.full(cl.S, -1)
    rank[order[:m]] = np.arange(m)
    pool = st.feasible(rho, theta)
    pool = pool[rank[cl.server[pool]] >= 0]
    if len(pool) < G:
        return None
    return pool[np.lexsort((pool, st.U[pool], rank[cl.server[pool]]))][:G]


def try_place(st: State, jid: int, job, picker, rho_nom, theta) -> bool:
    """Pick with the nominal estimate, price the pick, re-check theta;
    on overflow pick again with the larger estimate (at most 4 tries)."""
    F = st.cl.F
    rho_try = rho_nom
    for _ in range(4):
        gpus = picker(st, job, rho_try, theta)
        if gpus is None:
            return False
        rho, start = st.price(job, gpus)
        if st.fits(gpus, rho, theta):
            st.commit(jid, job, gpus, rho, start)
            return True
        rho_try = max(rho, rho_try * F(1.05))
    return False


@dataclasses.dataclass
class Schedule:
    assignment: list
    est_start: np.ndarray
    est_finish: np.ndarray
    est_makespan: float
    theta: float
    kappa: "int | None"
    max_busy_time: float


def freeze(st: State, n: int, theta, kappa) -> Schedule:
    F = st.cl.F
    start = np.full(n, -1.0, dtype=F)
    finish = np.full(n, -1.0, dtype=F)
    for jid, s in st.start.items():
        start[jid], finish[jid] = s, s + st.rho[jid]
    return Schedule(list(st.assignment), start, finish,
                    finish.max(initial=F(0.0)), theta, kappa,
                    st.U.max(initial=F(0.0)))


def sjf_bco(cl: Cluster, jobs, horizon: int, u: float) -> Schedule:
    """Algorithm 1 over a backlog that is all there at slot 0."""
    F = cl.F
    n = len(jobs)
    order = sorted(range(n), key=lambda j: (jobs[j].num_gpus, j))
    rho_nom = [nominal_rho(cl, j) for j in jobs]
    kappas = sorted({j.num_gpus for j in jobs} | {1})

    def attempt(theta):
        # Placement is a function of the state, so every kappa's attempt
        # starts from the FA-FFP prefix of jobs with G <= kappa, placed
        # once and copied; a prefix that fails fails every larger kappa.
        best, prefix, done = None, State(cl, u, n), 0
        for kappa in kappas:
            while done < n and jobs[order[done]].num_gpus <= kappa:
                j = order[done]
                if not try_place(prefix, j, jobs[j], fa_ffp, rho_nom[j],
                                 theta):
                    return best
                done += 1
            st = prefix.copy()
            if all(try_place(st, j, jobs[j], lbsgf, rho_nom[j], theta)
                   for j in order[done:]):
                cand = freeze(st, n, theta, kappa)
                if best is None or cand.est_makespan < best.est_makespan:
                    best = cand
        return best

    best = None
    left, right = F(1.0), F(horizon)
    while left <= right:
        theta = F(0.5) * (left + right)
        cand = attempt(theta)
        if cand is not None:
            if best is None or cand.est_makespan <= best.est_makespan:
                best = cand
            right = theta - F(1.0)
        else:
            left = theta + F(1.0)
    if best is None:
        raise RuntimeError("no feasible schedule within the horizon")
    return best


def online(cl: Cluster, jobs, arrivals, horizon: int, u: float
           ) -> tuple[Schedule, dict]:
    """The daemon's decisions over a stream: (schedule, outcome of each
    job id -- (gpus, slots, start), or None where it failed)."""
    F = cl.F
    theta = F(horizon)
    st = State(cl, u, len(jobs))
    outcomes = {}
    for j in sorted(range(len(jobs)),
                    key=lambda j: (int(arrivals[j]), jobs[j].num_gpus, j)):
        job = jobs[j]
        st.R = np.maximum(st.R, F(arrivals[j]))
        rho_nom = nominal_rho(cl, job)
        best = None
        for picker in (fa_ffp, lbsgf):
            gpus = picker(st, job, rho_nom, theta)
            if gpus is None:
                continue
            rho, start = st.price(job, gpus)
            if not st.fits(gpus, rho, theta):
                continue
            if best is None or start + rho < best[0]:
                best = (start + rho, gpus, rho, start)
        if best is None:
            outcomes[j] = None
            continue
        _, gpus, rho, start = best
        st.commit(j, job, gpus, rho, start)
        outcomes[j] = (gpus, rho, start)
    return freeze(st, len(jobs), theta, None), outcomes


def policy(name: str):
    """(backlog plan, online rule) of the policy ``name``.  The reference
    implements SJF-BCO alone and refuses any other, so that a run is
    never judged against a policy it did not run."""
    if name != "sjf-bco":
        raise ValueError(f"the reference implements 'sjf-bco' only, not "
                         f"{name!r}")
    return sjf_bco, online


@dataclasses.dataclass
class Sim:
    start: np.ndarray
    finish: np.ndarray
    makespan: float
    avg_jct: float


def simulate(cl: Cluster, jobs, assignment, arrivals=None,
             horizon: int = 10**7) -> Sim:
    """Run a schedule slot by slot, jumping from one change of the running
    set to the next (tau is constant in between)."""
    F = cl.F
    n, E = len(jobs), len(assignment)
    jid = [int(j) for j, _ in assignment]
    gpus = [np.asarray(g, dtype=np.int64) for _, g in assignment]
    queue = [[] for _ in range(cl.N)]
    for e, g in enumerate(gpus):
        for x in g.tolist():
            queue[x].append(e)
    head = [0] * cl.N
    arr = np.zeros(n, dtype=np.int64) if arrivals is None \
        else np.asarray(arrivals, dtype=np.int64)
    Y = np.stack([cl.per_server(g) for g in gpus]) if E else \
        np.zeros((0, cl.S), dtype=np.int64)
    G = np.asarray([jobs[j].num_gpus for j in jid], dtype=np.int64)
    rem = np.asarray([F(jobs[j].iters) for j in jid], dtype=F)
    start = np.full(n, -1, dtype=np.int64)
    finish = np.full(n, -1, dtype=np.int64)
    waiting = sorted(range(E), key=lambda e: jid[e])
    active: list[int] = []
    t = 0
    while t < horizon:
        ready = [e for e in waiting if arr[jid[e]] <= t
                 and all(queue[x][head[x]] == e for x in gpus[e].tolist())]
        for e in ready:
            waiting.remove(e)
            active.append(e)
            start[jid[e]] = t
        if not active:
            if not waiting:
                break
            nxt = min(int(arr[jid[e]]) for e in waiting)
            if nxt <= t:
                break
            t = min(nxt, horizon)
            continue
        act = np.asarray(active)
        p = contention(Y[act], G[act])
        n_srv = (Y[act] > 0).sum(axis=1)
        rate = np.asarray([tau(cl, jobs[jid[e]], int(pi), int(ni))
                           for e, pi, ni in zip(active, p, n_srv)], dtype=F)
        phi = np.floor(F(1.0) / rate)
        if (phi < 1).any():
            phi = np.maximum(phi, F(1.0) / rate)
        dt = int(max(1, min(math.ceil((rem[act] / phi).min()), horizon - t)))
        rem[act] = rem[act] - phi * F(dt)
        t += dt
        keep = []
        for e in active:
            if rem[e] <= F(EPS):
                finish[jid[e]] = t
                for x in gpus[e].tolist():
                    head[x] += 1
            else:
                keep.append(e)
        active = keep
    done = finish >= 0
    jct = (finish[done] - arr[done]).astype(F)
    return Sim(start=start, finish=finish,
               makespan=F(finish.max(initial=0)),
               avg_jct=jct.mean() if len(jct) else F(np.inf))
