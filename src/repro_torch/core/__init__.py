"""Paper core of the port: contention-aware scheduling of ring-all-reduce
DDL jobs (Yu et al., MobiHoc '22), mirroring :mod:`repro.core`.

Ported so far: the cluster and workload models, trace loading, the
Eq. (6)-(8) contention model, the unified scheduling API with SJF-BCO,
the §7 baselines and the adaptive extension, the columnar placement
engine, the slot simulator and :func:`run_scenario`, the preemption
primitives and policies (:mod:`repro_torch.core.preempt`), the §6 theory
certificate (:mod:`repro_torch.core.theory`) and the arrival-stream
helpers (:mod:`repro_torch.core.online`).  The scheduler service over
them is :mod:`repro_torch.service`.
"""
from repro_torch.core.api import (PlacementState, ScheduleRequest,
                                  ScheduleResult, SchedulingPolicy,
                                  SharedState, get_chooser, get_policy,
                                  list_choosers, list_policies, nominal_rho,
                                  probe_thetas, register_chooser,
                                  register_policy, rho_hat, try_place_group)
from repro_torch.core.cluster import Cluster, philly_cluster
from repro_torch.core.jobs import Job, philly_workload
from repro_torch.core.contention import (IncrementalEval, IterModel,
                                         contention_level, degradation,
                                         estimate_exec_time, evaluate,
                                         evaluate_many, evaluation_engine,
                                         predict_exec_time, scalar_tau_many,
                                         slots_for, stack_model, tau_backend,
                                         tau_bounds, tau_ladder)
from repro_torch.core.preempt import evict, evictable, replace, resize
from repro_torch.core.simulator import SimEvent, SimResult, simulate
from repro_torch.core.sjf_bco import fa_ffp, lbsgf
from repro_torch.core.scenario import (ArrivalSpec, ClusterSpec,
                                       ContentionStats, RunReport, Scenario,
                                       WorkloadSpec, run_scenario)
from repro_torch.core.theory import TheoryReport, report
from repro_torch.core.trace import load_trace, replay_trace

__all__ = [
    # unified scheduling API
    "ScheduleRequest", "ScheduleResult", "SchedulingPolicy",
    "register_policy", "get_policy", "list_policies",
    "register_chooser", "get_chooser", "list_choosers",
    "PlacementState", "SharedState", "nominal_rho", "rho_hat",
    "probe_thetas", "try_place_group",
    # scenarios
    "Scenario", "ClusterSpec", "WorkloadSpec", "ArrivalSpec",
    "RunReport", "ContentionStats", "run_scenario",
    "load_trace", "replay_trace",
    # problem model
    "Cluster", "philly_cluster", "Job", "philly_workload",
    "IterModel", "contention_level", "degradation", "evaluate",
    "evaluate_many", "IncrementalEval", "evaluation_engine",
    "scalar_tau_many", "slots_for",
    "estimate_exec_time", "predict_exec_time", "tau_bounds",
    "stack_model", "tau_backend", "tau_ladder",
    "SimEvent", "SimResult", "simulate",
    # algorithm subroutines
    "fa_ffp", "lbsgf",
    # preemption / elasticity primitives
    "evict", "evictable", "replace", "resize",
    "TheoryReport", "report",
]
