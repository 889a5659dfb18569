"""Unified scheduling API: one request/result pair, a policy registry, and
the shared busy-time machinery every policy builds on.

The paper's Fig. 3 loop is "search a placement -> evaluate it under
contention".  Every scheduler in this repo is an instance of that loop, so
the public surface is deliberately small:

  * :class:`ScheduleRequest` -- cluster, jobs, optional arrival times,
    horizon T, slack factor u, and policy-specific ``params``.  Batch
    scheduling (the paper's §4 setting, all jobs known at t=0) is the
    ``arrivals=None`` special case of the same code path that serves
    online streams.
  * :class:`ScheduleResult` -- placement + busy-time certificate, ready
    for :func:`repro_torch.core.simulator.simulate`.
  * :func:`register_policy` / :func:`get_policy` / :func:`list_policies`
    -- a decorator-based registry; ``get_policy(name)(request)`` runs any
    registered policy through one signature.

Supported building blocks for policy authors (promoted out of
``sjf_bco.py``, which previously kept them private):

  * :class:`PlacementState` -- busy-time clocks U (Eq. 15/16), real-time
    clocks R, and the placed-job snapshot used by the rho_hat(y^k)
    refinement of Eq. (8).
  * :func:`try_place` -- nominal-filter -> refine -> re-check loop
    (the Fig. 3 "re-evaluate after the schedule is known" retry).
  * :func:`bisect_theta` -- Algorithm 1's bisection on the per-GPU
    execution-time budget theta_u, generic over the per-theta attempt.
  * :func:`schedule_arrivals` -- the online epoch loop: advance the real
    clocks to each arrival and greedily place with a policy-supplied
    chooser.
  * :func:`finalize`, :func:`nominal_rho`, :func:`rho_hat`.

A new policy is ~20 lines::

    @register_policy("my-policy")
    def my_policy(request: ScheduleRequest) -> ScheduleResult:
        def attempt(theta):
            state = PlacementState(request.cluster)
            for job in request.jobs:
                if not try_place(state, job, my_picker,
                                 nominal_rho(request.cluster, job),
                                 request.u, theta):
                    return None
            return finalize(state, len(request.jobs), theta, None, "MINE")
        return bisect_theta(attempt, request.horizon, "MINE")
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Protocol, runtime_checkable

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import contention
from repro_torch.core.cluster import Cluster
from repro_torch.core.contention import (evaluate_many, predict_exec_time,
                                   resolve_engine, scalar_tau, slots_for,
                                   tau_bounds)
from repro_torch.core.jobs import Job

# --------------------------------------------------------------------------
# Request / result
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScheduleRequest:
    """One scheduling problem instance.

    ``arrivals`` (optional) gives the arrival slot of ``jobs[i]`` as
    ``arrivals[i]``; ``None`` -- or an all-zero array -- is the batch
    setting where every job is available at t=0.  ``params`` carries
    policy-specific knobs (e.g. ``{"kappas": [8]}`` for SJF-BCO,
    ``{"seed": 1}`` for RAND).  Every built-in policy honours
    ``"engine"`` (contention-model engine: ``"incremental"``,
    ``"batched"`` or ``"reference"`` -- all bit-identical, see
    :mod:`repro_torch.core.contention`); the try_place-based bisection policies
    (``sjf-bco``, ``ff``, ``ls``) additionally honour ``"warm_start"``
    (seed each theta of the bisection with the previous theta's
    placements).
    """

    cluster: Cluster
    jobs: list[Job]
    arrivals: np.ndarray | None = None
    horizon: int = 1200
    u: float = 1.5
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.jobs:
            raise ValueError("request needs at least one job")
        for i, j in enumerate(self.jobs):
            # Assignments carry job ids and the simulator indexes ``jobs``
            # with them, so ids must be 0..n-1 in list order.
            if j.jid != i:
                raise ValueError(
                    f"jobs[{i}].jid == {j.jid}; job ids must equal their "
                    "list index (renumber with dataclasses.replace)")
        if self.arrivals is not None:
            arr = np.asarray(self.arrivals)
            if arr.shape != (len(self.jobs),):
                raise ValueError(
                    f"arrivals shape {arr.shape} != ({len(self.jobs)},)")
            if np.any(arr < 0):
                raise ValueError("arrival slots must be >= 0")
            object.__setattr__(self, "arrivals", arr)

    @property
    def is_batch(self) -> bool:
        """True when every job is available at t=0 (the paper's setting)."""
        return self.arrivals is None or not np.any(self.arrivals > 0)

    def arrival_of(self, job: Job) -> int:
        """Arrival slot of ``job`` (0 in the batch setting)."""
        if self.arrivals is None:
            return 0
        return int(self.arrivals[self.jobs.index(job)])

    def arrival_items(self) -> list[tuple[Job, int]]:
        """(job, arrival) pairs, in request order."""
        if self.arrivals is None:
            return [(j, 0) for j in self.jobs]
        return [(j, int(t)) for j, t in zip(self.jobs, self.arrivals)]


@dataclasses.dataclass
class ScheduleResult:
    """Result of a scheduling policy, ready for the simulator.

    Subsumes the legacy ``Schedule``: ``assignment`` is the ordered
    (job id, gpu ids) placement, ``theta`` the busy-time budget the
    schedule was certified against (Eq. 16), ``max_busy_time`` the
    realised max U (== theta_tilde of Lemma 2 for the tightest feasible
    theta).
    """

    assignment: list[tuple[int, np.ndarray]]   # (job id, gpu ids), order
    est_start: np.ndarray
    est_finish: np.ndarray
    est_makespan: float
    theta: float
    kappa: int | None = None
    policy: str = ""
    max_busy_time: float = 0.0
    # Per-assignment-entry iteration quotas for preemptive schedules (a
    # jid may then appear in several entries -- its checkpointed
    # segments); None for the non-preemptive Eq. (3) setting.  Passed to
    # :func:`repro_torch.core.simulator.simulate` as ``quotas``.
    quotas: np.ndarray | None = None


@runtime_checkable
class SchedulingPolicy(Protocol):
    """A scheduling policy: one problem instance in, one schedule out."""

    def __call__(self, request: ScheduleRequest) -> ScheduleResult: ...


# --------------------------------------------------------------------------
# Policy registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, SchedulingPolicy] = {}
_BUILTINS_LOADED = False


def _load_builtins() -> None:
    """Import the built-in policy modules so their decorators run.

    Lazy so ``repro_torch.core.api`` has no imports of the modules that import
    it -- this is what removes the old ``POLICIES["sjf-bco"] = None``
    import-cycle patch.
    """
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    from repro_torch.core import (  # noqa: F401
        baselines, extensions, preempt, sjf_bco)


def register_policy(name: str, *aliases: str
                    ) -> Callable[[SchedulingPolicy], SchedulingPolicy]:
    """Decorator: make ``fn`` available as ``get_policy(name)``."""

    def deco(fn: SchedulingPolicy) -> SchedulingPolicy:
        """Register ``fn`` under ``name`` and every alias."""
        for key in (name, *aliases):
            key = key.lower()        # lookups lowercase too
            if key in _REGISTRY and _REGISTRY[key] is not fn:
                raise ValueError(f"policy {key!r} already registered")
            _REGISTRY[key] = fn
        fn.policy_name = name.lower()   # type: ignore[attr-defined]
        return fn

    return deco


def get_policy(name: str) -> SchedulingPolicy:
    """Look up a registered policy by name (case-insensitive)."""
    _load_builtins()
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown policy {name!r}; registered: {', '.join(list_policies())}")
    return _REGISTRY[key]


def list_policies() -> list[str]:
    """Sorted names of every registered policy."""
    _load_builtins()
    return sorted(_REGISTRY)


# --------------------------------------------------------------------------
# Online-chooser registry (the incremental face of the same policies)
# --------------------------------------------------------------------------

# A chooser factory binds a policy's per-arrival placement rule to a
# (cluster, u, params) context; the returned Chooser is exactly what the
# policy's own ``arrivals`` branch hands to :func:`schedule_arrivals`.
ChooserFactory = Callable[["Cluster", float, dict], "Chooser"]

_CHOOSERS: dict[str, ChooserFactory] = {}


def register_chooser(name: str, *aliases: str
                     ) -> Callable[[ChooserFactory], ChooserFactory]:
    """Decorator: register a policy's online chooser factory.

    Every policy with an ``arrivals`` path registers the factory that
    builds its per-arrival chooser, and its own online branch goes through
    the same factory -- so a long-running consumer (``repro_torch.service``)
    that pulls the chooser via :func:`get_chooser` and drives it against a
    persistent :class:`PlacementState` makes decision-for-decision the
    same placements as a one-shot :func:`schedule_arrivals` call."""

    def deco(fn: ChooserFactory) -> ChooserFactory:
        """Register ``fn`` under ``name`` and every alias."""
        for key in (name, *aliases):
            key = key.lower()
            if key in _CHOOSERS and _CHOOSERS[key] is not fn:
                raise ValueError(f"chooser {key!r} already registered")
            _CHOOSERS[key] = fn
        return fn

    return deco


def get_chooser(name: str) -> ChooserFactory:
    """Look up a registered online-chooser factory (case-insensitive).

    ``get_chooser(name)(cluster, u, params)`` returns the same
    :data:`Chooser` the policy's online branch uses, bound to the given
    context; stateful choosers (RAND's rng) carry ``stateful = True``."""
    _load_builtins()
    key = name.lower()
    if key not in _CHOOSERS:
        raise KeyError(
            f"policy {name!r} has no online chooser; "
            f"registered: {', '.join(sorted(_CHOOSERS))}")
    return _CHOOSERS[key]


def list_choosers() -> list[str]:
    """Sorted names of every registered online chooser."""
    _load_builtins()
    return sorted(_CHOOSERS)


# --------------------------------------------------------------------------
# Placement-engine axis
# --------------------------------------------------------------------------

# How the bisection policies advance their (theta, kappa) attempt forest:
# "columnar" runs the whole forest as one branch-vectorised array program
# over deduplicated state rows
# (:class:`repro_torch.core.columnar.ColumnarPlacement`); "scalar" walks one
# :class:`PlacementState` per branch (with the COW lineage sharing of
# ``try_place_group``) and is the bit-identity oracle.  Same selectable
# -oracle pattern as the ``engine``/``sweep``/``bisect`` axes.
PLACEMENTS = ("scalar", "columnar")

#: Job count from which the size-aware default flips to the columnar
#: engine, or ``None`` while no flip is warranted.  The port keeps the
#: reference's value (no crossover measured), so a request without a
#: ``placement`` param runs the scalar walk; :func:`repro_torch.core.
#: scenario.run_scenario` on a CUDA device asks for "columnar" explicitly,
#: which is what puts the step math on the card.
COLUMNAR_DEFAULT_MIN_JOBS: int | None = None


def resolve_placement(params: dict, n_jobs: int | None = None) -> str:
    """The request's ``placement`` param, validated.

    An explicit ``placement`` always wins.  Without one the default is
    size-aware: "scalar" below :data:`COLUMNAR_DEFAULT_MIN_JOBS` jobs,
    "columnar" at or above it (the constant is ``None``, so the default
    is "scalar" at every size); callers that pass no ``n_jobs`` -- the
    scalar-only validate sites -- default to "scalar" always.

    "scalar" is the per-branch ``PlacementState`` walk -- the bit-identity
    oracle, host NumPy only.  "columnar" advances the whole sweep x bisect
    forest as one [branches, S] array program (:class:`ColumnarPlacement`)
    -- identical decisions, strictly-array state, with its per-step
    reductions in the CUDA kernels of :mod:`repro_torch.kernels.placement`
    under the "kernel" backend.
    """
    placement = params.get("placement")
    if placement is None:
        return ("columnar" if COLUMNAR_DEFAULT_MIN_JOBS is not None
                and n_jobs is not None
                and n_jobs >= COLUMNAR_DEFAULT_MIN_JOBS else "scalar")
    if placement not in PLACEMENTS:
        raise ValueError(f"unknown placement {placement!r}; "
                         f"choose from {PLACEMENTS}")
    return placement


def resolve_columnar_backend(params: dict) -> str:
    """The request's ``columnar_backend`` param, resolved (default "auto").

    "auto" picks the CUDA "kernel" backend when the request's ``device``
    (see :func:`repro_torch.resolve_device`; default ``"cuda"``) is a CUDA
    device and eager "numpy" when it is the CPU; "kernel"/"numpy" force a
    backend ("kernel" on a CPU device runs the kernels' plain PyTorch
    versions).  Both backends are bit-identical in float64.
    """
    backend = params.get("columnar_backend", "auto")
    if backend == "auto":
        device = resolve_device(params.get("device", "cuda"))
        return "kernel" if device.type == "cuda" else "numpy"
    from repro_torch.core.columnar import COLUMNAR_BACKENDS
    if backend not in COLUMNAR_BACKENDS:
        raise ValueError(
            f"unknown columnar backend {backend!r}; choose 'auto' or one "
            f"of {COLUMNAR_BACKENDS}")
    return backend


# --------------------------------------------------------------------------
# Estimates (Table 1 / §5.1)
# --------------------------------------------------------------------------


def nominal_rho(cluster: Cluster, job: Job) -> float:
    """Contention-free lower estimate (tau at b_intra, single server)."""
    lo, _ = tau_bounds(cluster, job)
    return slots_for(job.iters, lo)


def rho_hat(cluster: Cluster, job: Job) -> float:
    """Schedule-independent mid-bracket estimate, used by theory checks."""
    lo, hi = tau_bounds(cluster, job)
    return slots_for(job.iters, 0.5 * (lo + hi))


# --------------------------------------------------------------------------
# Busy-time accounting (§5-3)
# --------------------------------------------------------------------------


class PlacementState:
    """Per-attempt scheduler state: busy clocks U, real clocks R, and the
    snapshot of placed jobs used for the rho_hat(y^k) refinement.

    ``engine`` selects how rho_hat(y^k) probes evaluate the Eq. (6)-(8)
    model (default: the module-wide :data:`repro_torch.core.contention.DEFAULT_ENGINE`):

      * ``"incremental"`` -- per-server sorted lists of the est_finish
        times of straddling placed jobs, updated once per commit; a probe's
        contention level p is then a suffix count (jobs still running at
        the candidate's start) per straddled server, so each rho_hat is
        O(straddled servers * log placed) + scalar Eq. (8) instead of a
        full [J, S] model pass;
      * ``"batched"`` -- :meth:`refined_rho_many` scores all candidates of
        a placement decision in one ``evaluate_many`` pass;
      * ``"reference"`` -- the original per-candidate ``evaluate`` loop.

    All three produce bit-identical estimates (and therefore identical
    schedules); see ``tests/test_batched_contention.py``.
    """

    def __init__(self, cluster: Cluster, engine: str | None = None):
        self.cluster = cluster
        self.engine = resolve_engine(engine)
        self.U = np.zeros(cluster.num_gpus)    # busy-time clock (Eq. 15/16)
        self.R = np.zeros(cluster.num_gpus)    # real-time clock (gang start)
        self.assignment: list[tuple[int, np.ndarray]] = []
        self.placed_jobs: list[Job] = []
        self.placed_y: list[np.ndarray] = []   # per-server GPU counts
        self.est_start: dict[int, float] = {}
        self.est_finish: dict[int, float] = {}
        # Per-assignment-entry (segment) bookkeeping.  Non-preemptive
        # policies commit one entry per job and never read these; the
        # preemption primitives (:mod:`repro_torch.core.preempt`) need the EXACT
        # committed floats (est_finish - est_start would not round-trip
        # rho) plus the entry <-> placed-row linkage to undo/truncate a
        # commit.  ``seg_quota`` is each entry's planned iteration share
        # (the job's full F_j until an eviction splits it), which is what
        # the simulator's per-segment execution consumes.
        self.seg_rho: list[float] = []         # committed rho per entry
        self.seg_start: list[float] = []       # committed gang start per entry
        self.seg_quota: list[float] = []       # planned iterations per entry
        self.seg_prev: list[int] = []          # previous entry of same jid, -1
        self.seg_row: list[int] = []           # placed_jobs row of the entry
        self.placed_fin: list[float] = []      # per-ROW est finish (rows of a
        #   split job carry their own truncated finishes; est_finish keeps
        #   only the job's latest)
        self._entry_of: dict[int, int] = {}    # jid -> latest live entry
        self.preempted = False                 # any evict happened here
        self.now = 0.0                         # decision clock (advance_to)
        # Per-server sorted est_finish of straddling placed jobs (Eq. 6
        # suffix counts for the incremental engine; maintained by commit).
        # Cloning shares these lists copy-on-write: ``_fin_owned[s]`` says
        # whether this state may mutate server s's list in place.
        self._straddle_fin: list[list[float]] = \
            [[] for _ in range(cluster.num_servers)]
        self._fin_owned = [True] * cluster.num_servers
        # Optional observer called after every commit with the exact
        # (job, gpus, rho, start) committed -- the write-ahead journal of
        # repro_torch.service captures placements here so a crash replay can
        # re-commit bit-identically (est_finish - est_start would NOT
        # round-trip rho through float subtraction).
        self.commit_hook: "Callable[[Job, np.ndarray, float, float], None] | None" = None
        # Optional observer called by :func:`repro_torch.core.preempt.evict` with
        # (job, t_ev, residual_job) after an eviction is applied -- the
        # service daemon journals EVICT/RESIZE records here.
        self.evict_hook: "Callable[[Job, float, Job], None] | None" = None

    def _y_of(self, gpus: np.ndarray) -> np.ndarray:
        return np.bincount(self.cluster.gpu_server[gpus],
                           minlength=self.cluster.num_servers)

    def clone(self) -> "PlacementState":
        """Independent copy of the attempt state: committing to the clone
        leaves the original untouched.  The batched (theta, kappa) sweep
        (``sjf-bco`` with ``params={"sweep": "batched"}``) and the
        speculative bisection's lineage forks both clone per branch.

        The per-server sorted-finish lists are shared copy-on-write:
        both sides drop ownership here, and :meth:`commit` copies a
        server's list the first time it inserts into an un-owned one --
        so a clone is O(placed jobs + servers) instead of O(total finish
        entries), which is what keeps heavy branching affordable at
        |J| ~ 1024."""
        new = PlacementState.__new__(PlacementState)
        new.cluster = self.cluster
        new.engine = self.engine
        new.U = self.U.copy()
        new.R = self.R.copy()
        new.assignment = list(self.assignment)
        new.placed_jobs = list(self.placed_jobs)
        new.placed_y = list(self.placed_y)
        new.est_start = dict(self.est_start)
        new.est_finish = dict(self.est_finish)
        new.seg_rho = list(self.seg_rho)
        new.seg_start = list(self.seg_start)
        new.seg_quota = list(self.seg_quota)
        new.seg_prev = list(self.seg_prev)
        new.seg_row = list(self.seg_row)
        new.placed_fin = list(self.placed_fin)
        new._entry_of = dict(self._entry_of)
        new.preempted = self.preempted
        new.now = self.now
        new._straddle_fin = list(self._straddle_fin)
        self._fin_owned = [False] * self.cluster.num_servers
        new._fin_owned = [False] * self.cluster.num_servers
        new.commit_hook = None      # observers watch one state, not forks
        new.evict_hook = None
        return new

    def advance_to(self, t: float) -> None:
        """Advance the real-time clocks to ``t`` (an arrival instant): a
        GPU idle before the arrival cannot have been used earlier.  Also
        records ``t`` as :attr:`now`, the state's decision clock -- the
        preemptive choosers read it as the eviction instant."""
        self.now = max(self.now, float(t))
        np.maximum(self.R, float(t), out=self.R)

    def _overlaps(self, start: float) -> np.ndarray:
        """Mask over placed rows whose estimated window covers ``start``.

        Per-ROW finishes (not per-jid): segments of a preempted job carry
        their own truncated finishes; for non-preemptive states the row
        finish equals ``est_finish[jid]`` exactly."""
        return np.asarray([fin > start + 1e-9 for fin in self.placed_fin],
                          dtype=bool)

    def _probe_p(self, job: Job, y_j: np.ndarray, start: float
                 ) -> tuple[int, int]:
        """(p, n_srv) of a candidate placement against the placed jobs:
        the Eq. (6) level is 1 + max over its straddled servers of the
        number of placed straddling jobs still running at ``start`` (a
        suffix count on the per-server sorted est_finish lists)."""
        p = 0
        n_srv = 0
        cut = start + 1e-9
        G = job.num_gpus
        straddle_fin = self._straddle_fin
        for s, y in enumerate(y_j.tolist()):
            if y > 0:
                n_srv += 1
                if y < G:
                    fin = straddle_fin[s]
                    p = max(p, len(fin) - bisect.bisect_right(fin, cut) + 1)
        return p, n_srv

    def _probe_rho(self, job: Job, y_j: np.ndarray, start: float) -> float:
        """Incremental rho_hat(y^k): Eq. (6) via :meth:`_probe_p`, then
        the scalar Eq. (8); tau_j needs nothing else.  On heterogeneous
        clusters the candidate's worst-member device terms ride along, so
        the probe prices the slow tier / isolated uplink it would land on."""
        p, n_srv = self._probe_p(job, y_j, start)
        cl = self.cluster
        if cl.is_heterogeneous:
            pos = y_j > 0
            tau = scalar_tau(
                cl, job, p, n_srv,
                speed=float(cl.server_speed_floor[pos].min()),
                bw_shared=float(cl.uplink_shared_or_inf[pos].min()),
                bw_isolated=float(cl.uplink_isolated_or_inf[pos].min()))
        else:
            tau = scalar_tau(cl, job, p, n_srv)
        return slots_for(job.iters, tau)

    def refined_rho(self, job: Job, gpus: np.ndarray) -> tuple[float, float]:
        """rho_hat_j(y^k): Eq. (8) against placed jobs overlapping the
        estimated gang start.  Returns (rho_hat, est_start)."""
        start = float(self.R[gpus].max()) if len(gpus) else 0.0
        y_j = self._y_of(gpus)
        if self.engine == "incremental":
            return self._probe_rho(job, y_j, start), start
        overlap = self._overlaps(start)
        overlap_jobs = [jb for jb, ov in zip(self.placed_jobs, overlap) if ov]
        overlap_y = [y for y, ov in zip(self.placed_y, overlap) if ov]
        Y_snap = np.asarray(overlap_y, dtype=np.int64).reshape(
            len(overlap_jobs), self.cluster.num_servers)
        return predict_exec_time(self.cluster, job, overlap_jobs, Y_snap,
                                 y_j), start

    def refined_rho_many(self, job: Job, gpu_sets: list[np.ndarray]
                         ) -> list[tuple[float, float]]:
        """Batch form of :meth:`refined_rho` over C candidate GPU sets.

        Under the ``"batched"`` engine all candidates are scored in a
        single ``evaluate_many`` pass over one [C, P+1, S] stack (placed
        jobs not overlapping a candidate's start are masked out, which is
        equivalent to omitting their rows).  Under ``"incremental"`` the
        per-candidate contention levels come from the suffix counts and
        one vectorised :func:`~repro_torch.core.contention.scalar_tau_many` call
        scores every candidate at once.  ``"reference"`` falls back to
        per-candidate :meth:`refined_rho`.  Results are identical across
        engines."""
        gpu_sets = [np.asarray(g) for g in gpu_sets]
        if not gpu_sets:
            return []
        if self.engine == "incremental":
            starts = [float(self.R[g].max()) if len(g) else 0.0
                      for g in gpu_sets]
            ps = np.empty(len(gpu_sets), dtype=np.int64)
            n_srv = np.empty(len(gpu_sets), dtype=np.int64)
            ys = np.empty((len(gpu_sets), self.cluster.num_servers),
                          dtype=np.int64)
            for c, (g, start) in enumerate(zip(gpu_sets, starts)):
                ys[c] = self._y_of(g)
                ps[c], n_srv[c] = self._probe_p(job, ys[c], start)
            if self.cluster.is_heterogeneous:
                speed, bw_sh, bw_iso = contention._hetero_mins(
                    self.cluster, ys > 0)
                taus = contention.scalar_tau_many(
                    self.cluster, job, ps, n_srv, speed=speed,
                    bw_shared=bw_sh, bw_isolated=bw_iso)
            else:
                taus = contention.scalar_tau_many(self.cluster, job, ps, n_srv)
            return [(slots_for(job.iters, float(tau)), start)
                    for tau, start in zip(taus, starts)]
        if self.engine != "batched":
            return [self.refined_rho(job, g) for g in gpu_sets]
        P = len(self.placed_jobs)
        C = len(gpu_sets)
        starts = [float(self.R[g].max()) if len(g) else 0.0 for g in gpu_sets]
        Y = np.zeros((C, P + 1, self.cluster.num_servers), dtype=np.int64)
        active = np.zeros((C, P + 1), dtype=bool)
        placed_Y = np.asarray(self.placed_y, dtype=np.int64).reshape(
            P, self.cluster.num_servers)
        for c, (g, start) in enumerate(zip(gpu_sets, starts)):
            active[c, :P] = self._overlaps(start)
            Y[c, :P] = placed_Y
            Y[c, P] = self._y_of(g)
            active[c, P] = True
        model = evaluate_many(self.cluster, self.placed_jobs + [job], Y,
                              active=active)
        return [(slots_for(job.iters, float(model.tau[c, P])), starts[c])
                for c in range(C)]

    def commit(self, job: Job, gpus: np.ndarray, rho: float, start: float,
               u: float) -> None:
        """Charge ``rho / u`` to the chosen GPUs and record the placement
        (Eq. 15 accounting + the rho-hat snapshot)."""
        self.U[gpus] += rho / u
        self.R[gpus] = start + rho
        jid = job.jid
        prev = self._entry_of.get(jid, -1)
        self.assignment.append((jid, gpus))
        y = self._y_of(gpus)
        self.placed_jobs.append(job)
        self.placed_y.append(y)
        if prev < 0:                  # first segment sets the job's start
            self.est_start[jid] = start
        self.est_finish[jid] = start + rho
        self.seg_rho.append(rho)
        self.seg_start.append(start)
        self.seg_quota.append(float(job.iters))
        self.seg_prev.append(prev)
        self.seg_row.append(len(self.placed_jobs) - 1)
        self.placed_fin.append(start + rho)
        self._entry_of[jid] = len(self.assignment) - 1
        G = job.num_gpus
        fin = start + rho
        for s, ys in enumerate(y.tolist()):
            if 0 < ys < G:
                if not self._fin_owned[s]:       # copy-on-first-write
                    self._straddle_fin[s] = list(self._straddle_fin[s])
                    self._fin_owned[s] = True
                bisect.insort(self._straddle_fin[s], fin)
        if self.commit_hook is not None:
            self.commit_hook(job, gpus, rho, start)

    def observe_finish(self, job: Job, gpus: np.ndarray,
                       finish: float) -> None:
        """Completion feedback: replace ``job``'s *estimated* finish with
        its observed (simulated or measured) one.

        The online epoch loop never looks back, so by default placements
        keep pricing contention against the rho-hat estimates.  A
        long-running scheduler that watches real executions
        (``repro.service`` with ``feedback="actual"``) calls this when a
        job completes: the rho_hat(y^k) overlap snapshot -- est_finish and
        the per-server straddler suffix-count lists -- is updated so later
        probes see the job gone at its actual finish, and the real-time
        clocks of GPUs last written by this job are pulled back so the
        arrival loop can start successors earlier.  This deliberately
        changes future decisions (it is the feedback extension, not the
        bit-identical default)."""
        jid = job.jid
        old = self.est_finish.get(jid)
        if old is None or old == finish:
            return
        gpus = np.asarray(gpus)
        self.est_finish[jid] = finish
        entry = self._entry_of.get(jid, -1)
        if entry >= 0:                 # keep the row finish in sync
            self.placed_fin[self.seg_row[entry]] = finish
        y = self._y_of(gpus)
        G = job.num_gpus
        for s, ys in enumerate(y.tolist()):
            if 0 < ys < G:
                if not self._fin_owned[s]:       # copy-on-first-write
                    self._straddle_fin[s] = list(self._straddle_fin[s])
                    self._fin_owned[s] = True
                fin = self._straddle_fin[s]
                i = bisect.bisect_left(fin, old)
                if i < len(fin) and fin[i] == old:
                    fin.pop(i)
                bisect.insort(fin, finish)
        # A GPU whose real-time clock was set by this very job frees at
        # the observed finish instead of the estimate.
        mask = self.R[gpus] == old
        self.R[gpus[mask]] = finish


# A picker maps (state, job, rho_nom, u, theta) -> gpu ids or None.
Picker = Callable[[PlacementState, Job, float, float, float],
                  "np.ndarray | None"]


class SharedState:
    """A :class:`PlacementState` shared by several speculative branches.

    The speculative bisection evaluates many thetas off one placement
    history; branches read the shared state freely and :meth:`acquire` an
    exclusive copy only when they are about to commit.  ``refs`` counts
    the live branches: acquiring with siblings still attached clones
    (:meth:`PlacementState.clone`, itself copy-on-write), acquiring as the
    sole owner reuses the state in place -- so a run that never diverges
    costs exactly one state, like the sequential oracle."""

    __slots__ = ("state", "refs")

    def __init__(self, state: PlacementState, refs: int = 1):
        self.state = state
        self.refs = refs

    def split(self, n_children: int) -> None:
        """Replace this holder's one reference by ``n_children`` of them."""
        self.refs += n_children - 1

    def acquire(self) -> "SharedState":
        """An exclusively-owned holder, cloning only if siblings remain."""
        if self.refs <= 1:
            return self
        self.refs -= 1
        return SharedState(self.state.clone())

    def release(self) -> None:
        """Drop one reference (a branch that failed or finished)."""
        self.refs -= 1


def try_place(state: PlacementState, job: Job, picker: Picker,
              rho_nom: float, u: float, theta: float, tries: int = 4,
              hint: "np.ndarray | None" = None) -> bool:
    """Pick GPUs with the nominal-estimate filter, refine rho_hat(y^k) for
    the chosen set, and re-check the Eq. (16) budget.  If the refined charge
    overflows theta on some GPU, re-filter with the refined estimate (which
    excludes the marginal GPUs) and retry -- mirroring the paper's
    "re-evaluate after the schedule is known" loop of Fig. 3.

    ``hint`` (optional) is a warm-start GPU set -- typically the job's
    placement from the previous theta of :func:`bisect_theta` -- committed
    directly if it passes the refined budget re-check, before the picker
    runs at all.

    rho_hat(y^k) is a pure function of the GPU set (the overlap snapshot is
    fixed until a commit), so candidate scores are memoised across tries;
    under the "batched" engine the escalation ladder's candidate sets are
    additionally pre-scored in a single ``evaluate_many`` pass.  (The
    ladder escalates by the plain 1.05 factor -- a lower bound on the real
    escalation ``max(rho, rho_try * 1.05)`` -- so when a refined rho jumps
    past it, the loop below falls back to scoring the unseen candidate
    individually; the result is identical either way.)"""
    scored: dict[tuple, tuple[float, float]] = {}
    if hint is not None:
        gpus = np.asarray(hint)
        rho, start = state.refined_rho(job, gpus)
        # max-then-add equals elementwise add-then-max (float addition is
        # monotone), so one scalar comparison decides the Eq. (16) check.
        if float(state.U[gpus].max()) + rho / u <= theta + 1e-9:
            state.commit(job, gpus, rho, start, u)
            return True
        scored[gpus.tobytes()] = (rho, start)
    # The ladder pre-calls the picker speculatively, which would desync a
    # stateful picker (e.g. RAND's rng): such pickers set ``stateful=True``
    # and are scored per-try only.
    if state.engine == "batched" and tries > 1 \
            and not getattr(picker, "stateful", False):
        ladder: dict[tuple, np.ndarray] = {}
        r = rho_nom
        for _ in range(tries):
            g = picker(state, job, r, u, theta)
            if g is None:
                break
            g = np.asarray(g)
            ladder.setdefault(tuple(g.tolist()), g)
            r *= 1.05
        if len(ladder) > 1:
            scored.update(zip(ladder, state.refined_rho_many(
                job, list(ladder.values()))))
    rho_try = rho_nom
    for _ in range(tries):
        gpus = picker(state, job, rho_try, u, theta)
        if gpus is None:
            return False
        gpus = np.asarray(gpus)
        key = gpus.tobytes()
        if key not in scored:
            scored[key] = state.refined_rho(job, gpus)
        rho, start = scored[key]
        if float(state.U[gpus].max()) + rho / u <= theta + 1e-9:
            state.commit(job, gpus, rho, start, u)
            return True
        rho_try = max(rho, rho_try * 1.05)
    return False


def _theta_runs(thetas: np.ndarray, keys: np.ndarray) -> list[np.ndarray]:
    """Split an ascending theta vector into runs of equal ``keys``."""
    cuts = np.flatnonzero(keys[1:] != keys[:-1]) + 1
    return np.split(thetas, cuts)


def try_place_group(thetas, shared: SharedState, job: Job, picker: Picker,
                    rho_nom: float, u: float, tries: int = 4
                    ) -> list[tuple[np.ndarray, "SharedState | None", bool]]:
    """:func:`try_place` for a whole group of thetas sharing one history.

    ``thetas`` (ascending) all reached this placement step with identical
    committed placements (held by ``shared``).  The group is advanced in
    lockstep and split only where the per-theta decisions of the
    sequential :func:`try_place` actually diverge:

      * the picker's feasible pool is the threshold set
        ``U + rho/u <= theta + 1e-9``, so thetas whose pools coincide pick
        the same GPUs (pools are nested in theta; the picker must declare
        this dependence with ``picker.theta_pool = True``);
      * the refined Eq. (16) re-check passes exactly for
        ``theta + 1e-9 >= max(U[gpus] + rho/u)``, so a group splits into a
        committing upper range and a retrying lower range.

    Returns ``(sub_thetas, shared_state, placed)`` triples covering
    ``thetas``; failed subgroups carry ``None``.  Decision-for-decision
    identical to running :func:`try_place` per theta, with states cloned
    only at divergence points (see :class:`SharedState`).
    """
    if not getattr(picker, "theta_pool", False):
        raise ValueError(
            f"picker {getattr(picker, '__name__', picker)!r} is not marked "
            "theta_pool; speculative placement needs theta to enter only "
            "through the U + rho/u <= theta feasibility pool")
    thetas = np.asarray(thetas, dtype=np.float64)
    if len(thetas) == 1 and shared.refs <= 1:
        # Singleton group holding its state exclusively: no split can
        # trigger and no sibling reads the state, so run the plain loop
        # (same decisions, none of the group bookkeeping).  This is the
        # dominant case once lineages have diverged.
        ok = try_place(shared.state, job, picker, rho_nom, u,
                       float(thetas[0]), tries=tries)
        return [(thetas, shared if ok else None, ok)]
    out: list[tuple[np.ndarray, SharedState | None, bool]] = []
    # Worklist items: (thetas, shared holder, rho_try, memoised scores).
    # Scores are pure functions of (state, gpu set) and every branch of a
    # work item reads the same un-mutated state, so the memo is shared.
    work = [(thetas, shared, rho_nom, {})]
    for _ in range(tries):
        next_work = []
        for th_g, holder, rho_try, scored in work:
            state = holder.state
            # Pool split: group thetas by how many GPUs clear the
            # rho_try-filter.  Equal counts <=> equal pools (threshold
            # sets are nested), hence identical picker decisions.  The
            # common no-split case needs only the two extreme counts.
            v = state.U + rho_try / u
            if len(th_g) == 1 or int((v <= th_g[0] + 1e-9).sum()) \
                    == int((v <= th_g[-1] + 1e-9).sum()):
                subs = [th_g]
            else:
                counts = np.searchsorted(np.sort(v), th_g + 1e-9,
                                         side="right")
                subs = _theta_runs(th_g, counts)
            outcomes = []      # (sub, kind, payload)
            n_live = 0
            for sub in subs:
                gpus = picker(state, job, rho_try, u, float(sub[0]))
                if gpus is None:
                    outcomes.append((sub, "fail", None))
                    continue
                gpus = np.asarray(gpus)
                key = gpus.tobytes()
                if key not in scored:
                    scored[key] = state.refined_rho(job, gpus)
                rho, start = scored[key]
                passes = sub + 1e-9 >= (state.U[gpus] + rho / u).max()
                lo, hi = sub[~passes], sub[passes]
                if len(hi):
                    outcomes.append((hi, "commit", (gpus, rho, start)))
                    n_live += 1
                if len(lo):
                    outcomes.append((lo, "retry", max(rho, rho_try * 1.05)))
                    n_live += 1
            holder.split(n_live)       # fails drop their reference
            for sub, kind, payload in outcomes:
                if kind == "fail":
                    out.append((sub, None, False))
                elif kind == "commit":
                    own = holder.acquire()
                    gpus, rho, start = payload
                    own.state.commit(job, gpus, rho, start, u)
                    out.append((sub, own, True))
                else:
                    next_work.append((sub, holder, payload, scored))
        work = next_work
        if not work:
            break
    for th_g, holder, _, _ in work:    # tries exhausted
        holder.release()
        out.append((th_g, None, False))
    return out


def finalize(state: PlacementState, n_jobs: int, theta: float,
             kappa: int | None, policy: str) -> ScheduleResult:
    """Freeze a placement attempt into a :class:`ScheduleResult`."""
    est_start = np.full(n_jobs, -1.0)
    est_finish = np.full(n_jobs, -1.0)
    for j, s in state.est_start.items():
        est_start[j] = s
        est_finish[j] = state.est_finish[j]
    return ScheduleResult(assignment=state.assignment, est_start=est_start,
                          est_finish=est_finish,
                          est_makespan=float(est_finish.max(initial=0.0)),
                          theta=theta, kappa=kappa, policy=policy,
                          max_busy_time=float(state.U.max(initial=0.0)),
                          quotas=np.asarray(state.seg_quota)
                          if state.preempted else None)


# --------------------------------------------------------------------------
# Generic control loops
# --------------------------------------------------------------------------


def probe_thetas(left: float, right: float, levels: int,
                 cutoff: float = -np.inf) -> list[float]:
    """The geometric probe ladder of the speculative bisection.

    Descends from the bracket midpoint assuming each probe comes back
    feasible -- the sequential bisection's next theta after a feasible
    midpoint is the midpoint of the *lower* half, so the ladder is the
    exact theta sequence of up to ``levels`` consecutive
    feasible-tightening steps, spaced geometrically (bracket-halving)
    inside ``[left, right]``.  Probing the descending chain (rather than
    the full decision tree) keeps the speculative attempts clustered:
    consecutive probes share almost all their placement decisions, and a
    mispredicted (infeasible) probe simply ends the committed walk early.

    ``cutoff`` prunes ladder tail entries that are almost certainly
    infeasible (probing those would buy nothing: an infeasible result
    ends the committed walk anyway, and near-boundary failures are the
    expensive ones).  The bracket midpoint is always kept, so every round
    still commits at least one bisection decision.
    """
    nodes: list[float] = []
    hi = right
    for _ in range(levels):
        if left > hi:
            break
        mid = 0.5 * (left + hi)
        if nodes and mid < cutoff:
            break
        nodes.append(mid)
        hi = mid - 1.0
    return nodes


def bisect_theta(attempt: Callable[..., "ScheduleResult | None"],
                 horizon: int, policy: str,
                 warm_start: bool = False,
                 attempt_many: "Callable[[list[float]], dict[float, ScheduleResult | None]] | None" = None,
                 levels: int = 3, floor: float = -np.inf,
                 prune: bool = True) -> ScheduleResult:
    """Algorithm 1's outer loop: bisection on the busy-time budget theta_u.

    ``attempt(theta)`` returns the best schedule feasible under that
    budget, or None.  Feasible => tighten (search below theta);
    infeasible => relax.  Matches the paper's "theta_u^f is the maximum
    execution time limit returned by policy f" for the baselines too.

    With ``warm_start=True`` the attempt is called as ``attempt(theta,
    prev)`` where ``prev`` is the schedule committed at the previous
    feasible theta (or None); policies use its placements as the initial
    candidate set (see ``try_place``'s ``hint``), so each bisection step
    starts from a known-good placement instead of searching from scratch.

    With ``attempt_many`` set (and ``warm_start`` off -- a warm start
    makes each attempt depend on the previous one, which cannot be
    speculated), the bisection runs **speculatively**: each round scores
    every theta of the :func:`probe_thetas` ladder in one batched
    ``attempt_many`` call, then commits bisection decisions by walking
    the exact sequential update rule over the precomputed results until
    the next theta falls outside the ladder (the first mispredicted,
    i.e. infeasible, probe).  Unconsumed probe results are discarded, so
    the final schedule -- best feasible theta, its kappa, its placements
    -- is bit-identical to the sequential oracle's.

    ``prune=True`` (the default) additionally drops ladder entries in the
    bottom quarter of the bracket -- the right trade when every extra
    probe walks its own per-branch placement lineage.  Engines whose
    marginal branch cost is near zero (the columnar placement program,
    where an extra theta is one more row of the same array ops) pass
    ``prune=False`` to keep the whole ladder and commit several bisection
    decisions per round.  Pruning never changes the result, only how
    many rounds the bisection needs.
    """
    best: ScheduleResult | None = None
    prev: ScheduleResult | None = None
    left, right = 1.0, float(horizon)
    speculative = attempt_many is not None and not warm_start and levels > 1
    results: dict[float, ScheduleResult | None] = {}
    while left <= right:
        theta = 0.5 * (left + right)
        if speculative:
            if theta not in results:
                # Results are cached across rounds: a probe evaluated but
                # not yet consumed (the walk broke off elsewhere) is free
                # when a later bracket's midpoint lands on it.  Ladder
                # entries are pruned below (a) the policy's feasibility
                # floor (e.g. the largest single-job charge rho_nom/u: no
                # GPU could fit that job under a smaller budget), (b) the
                # bottom quarter of the bracket, where the committed
                # `left` (the largest theta proven infeasible, plus one)
                # says infeasibility is close -- an infeasible probe ends
                # the walk anyway, and near-boundary failures are the
                # expensive attempts.  Pruning never changes the result:
                # a pruned theta the walk does need is simply evaluated
                # as the next round's bracket midpoint.
                cut = max(floor, left + (right - left) / 4.0) if prune \
                    else floor
                todo = [th for th in probe_thetas(left, right, levels, cut)
                        if th not in results]
                results.update(attempt_many(todo))
            while left <= right:
                theta = 0.5 * (left + right)
                if theta not in results:
                    break           # mispredicted: start the next round
                cand = results[theta]
                if cand is not None:
                    prev = cand
                    if best is None or cand.est_makespan <= best.est_makespan:
                        best = cand
                    right = theta - 1.0
                else:
                    left = theta + 1.0
            continue
        cand = attempt(theta, prev) if warm_start else attempt(theta)
        if cand is not None:
            prev = cand
            if best is None or cand.est_makespan <= best.est_makespan:
                best = cand
            right = theta - 1.0
        else:
            left = theta + 1.0
    if best is None:
        raise RuntimeError(f"{policy}: no feasible schedule within horizon; "
                           "increase T")
    return best


# An online chooser places (and commits) one arrived job, or returns False.
Chooser = Callable[[PlacementState, Job, float], bool]


def schedule_arrivals(request: ScheduleRequest, choose: Chooser,
                      policy: str) -> ScheduleResult:
    """The online epoch loop shared by every policy's ``arrivals`` path.

    Jobs are visited in (arrival, G_j) order; the real-time clocks are
    advanced to each arrival instant before the policy's ``choose``
    places-and-commits the job against the live busy-time clocks.  There
    is no theta bisection online (the stream is open-ended), so the
    budget is the horizon, matching the paper's RAND convention.
    """
    order = sorted(request.arrival_items(),
                   key=lambda it: (it[1], it[0].num_gpus, it[0].jid))
    state = PlacementState(request.cluster,
                           engine=request.params.get("engine"))
    theta = float(request.horizon)
    for job, arrival in order:
        state.advance_to(arrival)
        if not choose(state, job, theta):
            raise RuntimeError(f"{policy}: cannot place job {job.jid} "
                               f"arriving at slot {arrival}")
    return finalize(state, len(request.jobs), theta, None, policy)


def pick_best_finish(state: PlacementState, job: Job, pickers: list[Picker],
                     rho_nom: float, u: float, theta: float) -> bool:
    """Adaptive pack-or-spread: evaluate every picker's placement with the
    refined rho_hat(y^k) and commit whichever finishes earliest.  Shared by
    SJF-BCO+ and the online path (where queueing delay IS the est-finish
    penalty)."""
    cands = []
    for picker in pickers:
        gpus = picker(state, job, rho_nom, u, theta)
        if gpus is not None:
            cands.append(np.asarray(gpus))
    best = None  # (est_finish, gpus, rho, start)
    for gpus, (rho, start) in zip(cands, state.refined_rho_many(job, cands)):
        if float(state.U[gpus].max()) + rho / u > theta + 1e-9:
            continue
        if best is None or start + rho < best[0]:
            best = (start + rho, gpus, rho, start)
    if best is None:
        return False
    _, gpus, rho, start = best
    state.commit(job, gpus, rho, start, u)
    return True


# Re-exported here so the columnar engine is reachable from the one
# scheduling surface (placed after ScheduleResult: columnar.py imports it
# lazily for result construction).
from repro_torch.core.columnar import ColumnarPlacement  # noqa: E402

__all__ = [
    "ScheduleRequest", "ScheduleResult", "SchedulingPolicy",
    "register_policy", "get_policy", "list_policies",
    "register_chooser", "get_chooser", "list_choosers", "ChooserFactory",
    "PlacementState", "Picker", "Chooser", "SharedState",
    "ColumnarPlacement", "PLACEMENTS", "resolve_placement",
    "try_place", "try_place_group", "finalize", "bisect_theta",
    "probe_thetas", "schedule_arrivals",
    "pick_best_finish", "nominal_rho", "rho_hat",
]
