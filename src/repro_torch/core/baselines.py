"""Baseline scheduling policies from §7-2: First-Fit, List-Scheduling, RAND,
plus the GADGET-style reserved-bandwidth ablation.

All baselines share SJF-BCO's busy-time accounting (U clocks, refined
rho_hat(y^k)/u charging, via :mod:`repro_torch.core.api`) so the comparison
isolates the *placement policy*:

  * FF   -- walk servers in id order, take the first G_j feasible GPUs
            (packs into fewest servers; fragmentation-averse but
            contention/overhead-oblivious);
  * LS   -- globally least-loaded feasible GPUs (balances busy time but may
            span many servers => high overhead + contention);
  * RAND -- random servers/GPUs with theta_u = T (paper sets the RAND limit
            to the horizon to avoid long feasibility searches).

FF and LS bisect their own theta_u like SJF-BCO does, per the paper's
"theta_u^f is the maximum execution time limit returned by policy f".
Baselines keep the user-submitted arrival order (no SJF sort).  With
``request.arrivals`` set, every baseline runs the shared online epoch loop
with its own picker (theta_u = T, as online has no bisection).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.api import (Chooser, PlacementState, Picker, ScheduleRequest,
                            ScheduleResult, SharedState, bisect_theta,
                            finalize, nominal_rho, register_chooser,
                            register_policy, resolve_columnar_backend,
                            resolve_placement, schedule_arrivals, try_place,
                            try_place_group)
from repro_torch.core.columnar import ColumnarPlacement
from repro_torch.core.jobs import Job

__all__ = ["first_fit_policy", "list_scheduling_policy", "random_policy_policy",
           "reserved_bandwidth_policy"]


def _ff_pick(state: PlacementState, job: Job, rho_nom: float, u: float,
             theta: float) -> np.ndarray | None:
    # Server-major, GPU-id order == first fit from server to server.
    ids = np.flatnonzero(state.U + rho_nom / u <= theta + 1e-9)
    if len(ids) < job.num_gpus:
        return None
    return ids[: job.num_gpus]


def _ls_pick(state: PlacementState, job: Job, rho_nom: float, u: float,
             theta: float) -> np.ndarray | None:
    feasible = np.flatnonzero(state.U + rho_nom / u <= theta + 1e-9)
    if len(feasible) < job.num_gpus:
        return None
    order = feasible[np.argsort(state.U[feasible], kind="stable")]
    return order[: job.num_gpus]


def _ff_pick_many(cluster, U: np.ndarray, feasible: np.ndarray,
                  job: Job) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised :func:`_ff_pick` over a batch of branch rows: per row,
    the first G_j feasible GPUs in id order.  A stable argsort of the
    negated mask lists feasible ids first, in id order -- exactly the
    scalar ``np.flatnonzero`` prefix."""
    ok = feasible.sum(axis=1) >= job.num_gpus
    gpus = np.argsort(~feasible, axis=1, kind="stable")[:, :job.num_gpus]
    return gpus, ok


def _ls_pick_many(cluster, U: np.ndarray, feasible: np.ndarray,
                  job: Job) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised :func:`_ls_pick` over a batch of branch rows: per row,
    the G_j least-loaded feasible GPUs.  The stable argsort over
    inf-masked clocks orders ties by GPU id, exactly like the scalar
    subarray sort (pool members keep their relative index order)."""
    ok = feasible.sum(axis=1) >= job.num_gpus
    gpus = np.argsort(np.where(feasible, U, np.inf), axis=1,
                      kind="stable")[:, :job.num_gpus]
    return gpus, ok


# theta enters both pickers only through the U + rho/u <= theta + 1e-9
# pool, so the speculative bisection may advance theta groups in lockstep
# and the columnar engine may batch whole branch stacks per pick.
_ff_pick.theta_pool = True
_ls_pick.theta_pool = True
_ff_pick.pick_many = _ff_pick_many
_ls_pick.pick_many = _ls_pick_many


def _picker_chooser(picker: Picker, cluster, u: float) -> Chooser:
    """Online chooser of a pure-picker baseline: try_place per arrival."""
    rho_noms: dict[int, float] = {}

    def choose(state: PlacementState, job: Job, theta: float) -> bool:
        if job.jid not in rho_noms:
            rho_noms[job.jid] = nominal_rho(cluster, job)
        return try_place(state, job, picker, rho_noms[job.jid], u, theta)

    return choose


@register_chooser("ff")
def ff_chooser(cluster, u: float, params: dict) -> Chooser:
    """Online First-Fit: server-major first feasible GPUs per arrival."""
    return _picker_chooser(_ff_pick, cluster, u)


@register_chooser("ls")
def ls_chooser(cluster, u: float, params: dict) -> Chooser:
    """Online List-Scheduling: least-loaded feasible GPUs per arrival."""
    return _picker_chooser(_ls_pick, cluster, u)


def _columnar_attempts(cluster, jobs: list[Job], rho_noms: dict[int, float],
                       u: float, thetas: list[float], picker: Picker,
                       engine: str | None, name: str,
                       backend: str = "numpy", device=None
                       ) -> "dict[float, ScheduleResult | None]":
    """All theta attempts of one picker as a single columnar program.

    One branch per theta of a :class:`ColumnarPlacement`; the whole
    ladder advances a job per :meth:`place` call, sharing (and
    re-merging) state rows wherever the budgets pick the same GPUs.
    Decision-for-decision identical to the scalar try_place loop per
    theta, hence bit-identical schedules.  ``backend`` selects where the
    step math runs (the FF/LS pickers carry no kernel ranking, so
    "kernel" runs only the probe scoring on ``device`` and keeps per-step
    pick_many calls)."""
    ths = sorted(float(th) for th in thetas)
    col = ColumnarPlacement(cluster, ths, jobs, u, engine=engine,
                            backend=backend, device=device)
    for job in jobs:                       # request order (no SJF sort)
        col.place(job, rho_noms[job.jid], (picker,), 0)
        if not col.alive.any():
            break
    return {th: col.result(b, th, None, name) for b, th in enumerate(ths)}


def _picker_policy(request: ScheduleRequest, picker: Picker, name: str
                   ) -> ScheduleResult:
    """Shared FF/LS skeleton: online epoch loop or batch theta bisection.

    Honours the ``engine``/``bisect``/``warm_start``/``placement`` params
    exactly as ``sjf-bco`` does (``placement="scalar"``, the default, is
    the per-branch oracle walk and the fallback under ``warm_start``;
    ``"columnar"`` batches each attempt's theta ladder as one
    :class:`~repro_torch.core.columnar.ColumnarPlacement` program)."""
    cluster, u = request.cluster, request.u
    engine = request.params.get("engine")
    placement = resolve_placement(
        request.params, len(request.jobs) if request.is_batch else None)

    if not request.is_batch:
        return schedule_arrivals(
            request, _picker_chooser(picker, cluster, u), name)

    rho_noms = {j.jid: nominal_rho(cluster, j) for j in request.jobs}

    jobs = request.jobs

    bisect_mode = request.params.get("bisect", "speculative")
    if bisect_mode not in ("speculative", "sequential"):
        raise ValueError(f"unknown bisect mode {bisect_mode!r}; "
                         "choose 'speculative' or 'sequential'")
    warm = bool(request.params.get("warm_start"))
    use_columnar = placement == "columnar" and not warm
    backend = resolve_columnar_backend(request.params) if use_columnar \
        else "numpy"
    device = request.params.get("device")

    def attempt(theta: float,
                prev: ScheduleResult | None = None) -> ScheduleResult | None:
        if use_columnar:
            return _columnar_attempts(cluster, jobs, rho_noms, u, [theta],
                                      picker, engine, name,
                                      backend, device)[float(theta)]
        hints = dict(prev.assignment) if prev is not None else {}
        state = PlacementState(cluster, engine=engine)
        for job in jobs:
            if not try_place(state, job, picker, rho_noms[job.jid], u, theta,
                             hint=hints.get(job.jid)):
                return None
        return finalize(state, len(jobs), theta, None, name)

    attempt_many = None
    if bisect_mode == "speculative" and not warm:
        def attempt_many(thetas: list[float]
                         ) -> "dict[float, ScheduleResult | None]":
            if use_columnar:
                return _columnar_attempts(cluster, jobs, rho_noms, u,
                                          thetas, picker, engine, name,
                                          backend, device)
            # One shared state for the whole probe ladder; theta groups
            # advance in lockstep and fork (copy-on-write) only where the
            # budgets change a placement decision.
            out: dict[float, ScheduleResult | None] = {}
            root = SharedState(PlacementState(cluster, engine=engine))
            work = [(np.asarray(sorted(thetas), dtype=np.float64), root, 0)]
            while work:
                th_g, holder, idx = work.pop()
                if idx == len(jobs):
                    for th in th_g:
                        out[float(th)] = finalize(holder.state, len(jobs),
                                                  float(th), None, name)
                    holder.release()
                    continue
                job = jobs[idx]
                for sub, sh, ok in try_place_group(
                        th_g, holder, job, picker, rho_noms[job.jid], u):
                    if ok:
                        work.append((sub, sh, idx + 1))
                    else:
                        for th in sub:
                            out[float(th)] = None
            return out

    return bisect_theta(attempt, request.horizon, name, warm_start=warm,
                        attempt_many=attempt_many,
                        levels=int(request.params.get("bisect_levels", 4)),
                        floor=max(rho_noms.values()) / u)


@register_policy("ff")
def first_fit_policy(request: ScheduleRequest) -> ScheduleResult:
    return _picker_policy(request, _ff_pick, "FF")


@register_policy("ls")
def list_scheduling_policy(request: ScheduleRequest) -> ScheduleResult:
    return _picker_policy(request, _ls_pick, "LS")


def _rand_picker(rng: np.random.Generator) -> Picker:
    """Random feasible GPUs, drawing from ``rng`` (stateful: see try_place)."""

    def picker(st, job, rho_nom, uu, th):
        feasible = np.flatnonzero(st.U + rho_nom / uu <= th + 1e-9)
        if len(feasible) < job.num_gpus:
            return None
        return rng.choice(feasible, size=job.num_gpus, replace=False)

    picker.stateful = True   # consumes rng draws; see try_place's ladder
    return picker


@register_chooser("rand")
def rand_chooser(cluster, u: float, params: dict) -> Chooser:
    """Online RAND: random feasible GPUs per arrival.  Stateful (the rng
    advances with every attempt): the chooser carries a ``stateful``
    attribute plus ``get_state``/``set_state`` accessors exposing the
    generator's ``bit_generator.state`` (a JSON-safe dict of ints), which
    the service daemon journals after every decision so crash recovery
    replays RAND decision-for-decision too."""
    rng = np.random.default_rng(params.get("seed", 0))
    picker = _rand_picker(rng)

    def choose(state: PlacementState, job: Job, th: float) -> bool:
        return try_place(state, job, picker, nominal_rho(cluster, job), u, th)

    def get_state() -> dict:
        return rng.bit_generator.state

    def set_state(snapshot: dict) -> None:
        rng.bit_generator.state = snapshot

    choose.stateful = True
    choose.get_state = get_state
    choose.set_state = set_state
    return choose


rand_chooser.stateful = True


@register_policy("rand")
def random_policy_policy(request: ScheduleRequest) -> ScheduleResult:
    """RAND with theta_u = T.  ``request.params``: ``seed`` (default 0).
    The picker is stateful (rng draws per attempt), so there is no
    columnar path: the ``placement`` param is validated but both values
    run the scalar walk (columnar == scalar trivially)."""
    cluster, u = request.cluster, request.u
    engine = request.params.get("engine")
    resolve_placement(request.params)
    theta = float(request.horizon)

    if not request.is_batch:
        return schedule_arrivals(
            request, rand_chooser(cluster, u, request.params), "RAND")

    rng = np.random.default_rng(request.params.get("seed", 0))
    picker = _rand_picker(rng)
    state = PlacementState(cluster, engine=engine)
    for job in request.jobs:
        if not try_place(state, job, picker, nominal_rho(cluster, job),
                         u, theta):
            raise RuntimeError("RAND: no feasible schedule within horizon")
    return finalize(state, len(request.jobs), theta, None, "RAND")


@register_chooser("reserved")
def reserved_chooser(cluster, u: float, params: dict) -> Chooser:
    """Online RESERVED: least-loaded GPUs charged at the contention-free
    nominal estimate (the reserved-bandwidth optimism, per arrival)."""

    def place_nominal(state: PlacementState, job: Job, theta: float) -> bool:
        rho = nominal_rho(cluster, job)
        gpus = _ls_pick(state, job, rho, u, theta)
        if gpus is None or np.any(state.U[gpus] + rho / u > theta + 1e-9):
            return False
        start = float(state.R[gpus].max()) if len(gpus) else 0.0
        state.commit(job, np.asarray(gpus), rho, start, u)
        return True

    return place_nominal


@register_policy("reserved")
def reserved_bandwidth_policy(request: ScheduleRequest) -> ScheduleResult:
    """GADGET-style ablation [22]: schedule as if each job had reserved,
    contention-free bandwidth (rho charged at its nominal lower estimate,
    placement = least-loaded GPUs).  The simulator *does* model contention,
    so the actual makespan of this schedule exposes the optimism the paper
    argues against.  Commits at the nominal rho (no refined re-check
    ladder), so there is no columnar path: the ``placement`` param is
    validated but both values run the scalar walk."""
    cluster, u = request.cluster, request.u
    engine = request.params.get("engine")
    resolve_placement(request.params)
    place_nominal = reserved_chooser(cluster, u, request.params)

    if not request.is_batch:
        return schedule_arrivals(request, place_nominal, "RESERVED")

    jobs = request.jobs

    def attempt(theta: float) -> ScheduleResult | None:
        state = PlacementState(cluster, engine=engine)
        for job in jobs:
            if not place_nominal(state, job, theta):
                return None
        return finalize(state, len(jobs), theta, None, "RESERVED")

    return bisect_theta(attempt, request.horizon, "RESERVED")
