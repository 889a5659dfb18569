"""The port's preemption primitives and preemptive policies against the
JAX reference, bit for bit.

``evict`` / ``replace`` / ``resize`` are pure clock and quota surgery, so
after each primitive the port's :class:`PlacementState` must hold the
reference's floats exactly (U, R, est_start/est_finish, the segment
lists, the straddler suffix lists).  The three policies
(``sjf-bco-dynamic``, ``gadget-elastic``, ``wang-ca``) must emit the
reference's segmented schedules online and in batch, under every
contention engine, and the card's configuration (batched engine, the
kernel backends) on the kernels' plain versions.  The segmented
schedules simulate identically on every simulator axis, and the daemon
drains them as the reference's daemon does.  The traces are
``tests/test_preempt_equivalence.py``'s.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as rc
import repro.core.preempt as rpre
import repro_torch.core as tc
import repro_torch.core.preempt as tpre
from repro.service import Daemon as RDaemon
from repro.service import QueueManager as RQueue
from repro.service import TenantConfig as RTenant
from repro_torch.convert import from_reference
from repro_torch.core.contention import tau_backend
from repro_torch.kernels import launch_counts
from repro_torch.service import Daemon, MemoryStore, QueueManager, \
    TenantConfig

ENGINES = ("reference", "batched", "incremental")
HETERO = dict(speed_tiers=((50.0, 0.5), (12.5, 0.5)),
              link_classes=((1.25, "shared", 0.5), (1.25, "isolated", 0.5)))


def _evict_trace(mod):
    cluster = mod.Cluster(capacities=(4, 4))
    jobs = [mod.Job(jid=0, num_gpus=8, iters=4000, grad_size=0.25, batch=32,
                    dt_fwd=3e-4, dt_bwd=8e-3)]
    jobs += [mod.Job(jid=i, num_gpus=2, iters=200, grad_size=0.05, batch=32,
                     dt_fwd=3e-4, dt_bwd=8e-3) for i in range(1, 4)]
    return cluster, jobs, np.array([0, 5, 6, 7], dtype=np.int64), 10**6


def _resize_trace(mod):
    cluster = mod.Cluster(capacities=(4,))
    jobs = [mod.Job(jid=0, num_gpus=4, iters=2000, grad_size=0.25, batch=32,
                    dt_fwd=3e-4, dt_bwd=8e-3),
            mod.Job(jid=1, num_gpus=2, iters=100, grad_size=0.05, batch=32,
                    dt_fwd=3e-4, dt_bwd=8e-3)]
    return cluster, jobs, np.array([0, 5], dtype=np.int64), 35


TRACES = [("sjf-bco-dynamic", _evict_trace), ("gadget-elastic", _evict_trace),
          ("wang-ca", _evict_trace), ("gadget-elastic", _resize_trace)]


def _carry(cluster, jobs):
    return from_reference(cluster.to_payload(),
                          [dataclasses.asdict(j) for j in jobs])


def _assert_schedules_equal(a, b):
    assert len(a.assignment) == len(b.assignment)
    for (j1, g1), (j2, g2) in zip(a.assignment, b.assignment):
        assert j1 == j2 and np.array_equal(g1, g2)
    assert (a.quotas is None) == (b.quotas is None)
    if a.quotas is not None:
        assert np.array_equal(a.quotas, b.quotas)
    assert np.array_equal(a.est_start, b.est_start)
    assert np.array_equal(a.est_finish, b.est_finish)
    assert (a.theta, a.kappa, a.est_makespan, a.max_busy_time) == \
        (b.theta, b.kappa, b.est_makespan, b.max_busy_time)


def _assert_sims_equal(a, b):
    assert [dataclasses.astuple(e) for e in a.events] == \
        [dataclasses.astuple(e) for e in b.events]
    assert np.array_equal(a.start, b.start)
    assert np.array_equal(a.finish, b.finish)
    assert (a.makespan, a.avg_jct, a.completed, a.peak_contention,
            a.busy_gpu_slots) == (b.makespan, b.avg_jct, b.completed,
                                  b.peak_contention, b.busy_gpu_slots)


def _assert_states_equal(a, b):
    assert np.array_equal(a.U, b.U) and np.array_equal(a.R, b.R)
    assert a.est_start == b.est_start and a.est_finish == b.est_finish
    for name in ("seg_rho", "seg_start", "seg_quota", "seg_prev", "seg_row",
                 "placed_fin", "_entry_of", "_straddle_fin", "preempted",
                 "now"):
        assert getattr(a, name) == getattr(b, name), name
    assert [dataclasses.asdict(j) for j in a.placed_jobs] == \
        [dataclasses.asdict(j) for j in b.placed_jobs]
    assert len(a.assignment) == len(b.assignment)
    for (j1, g1), (j2, g2) in zip(a.assignment, b.assignment):
        assert j1 == j2 and np.array_equal(g1, g2)


def _both(policy, trace, engine=None):
    cluster, jobs, arr, horizon = trace(rc)
    params = {} if engine is None else {"engine": engine}
    want = rc.get_policy(policy)(rc.ScheduleRequest(
        cluster=cluster, jobs=jobs, arrivals=arr, horizon=horizon,
        params=dict(params)))
    p_cluster, p_jobs = _carry(cluster, jobs)
    got = tc.get_policy(policy)(tc.ScheduleRequest(
        cluster=p_cluster, jobs=p_jobs, arrivals=arr, horizon=horizon,
        params=dict(params)))
    return want, got


class TestPrimitives:
    """Each primitive applied to the same committed state on both sides."""

    def _states(self, engine, hetero=False):
        out = []
        for mod in (rc, tc):
            cluster = mod.Cluster(capacities=(4, 4, 4)) if not hetero else \
                mod.philly_cluster(3, seed=5, **HETERO)
            state = mod.PlacementState(cluster, engine=engine)
            jobs = [mod.Job(jid=i, num_gpus=g, iters=1000 + 300 * i,
                            grad_size=0.05 * (i + 1), batch=32,
                            dt_fwd=3e-4, dt_bwd=8e-3)
                    for i, g in enumerate((6, 2, 4, 3))]
            gpu_sets = [np.arange(6), np.array([6, 7]),
                        np.array([2, 3, 8, 9]), np.array([4, 5, 10])]
            for job, gpus in zip(jobs, gpu_sets):
                rho, start = state.refined_rho(job, gpus)
                state.commit(job, gpus, rho, start, 1.5)
            out.append((state, jobs))
        return out

    @pytest.mark.parametrize("hetero", [False, True])
    @pytest.mark.parametrize("engine", ENGINES)
    def test_evict_replace_resize_clocks(self, engine, hetero):
        (rs, rjobs), (ts, tjobs) = self._states(engine, hetero)
        _assert_states_equal(rs, ts)
        t = rs.seg_start[0] + 0.37 * rs.seg_rho[0]
        for jid in range(4):
            for when in (t, 0.0, 1e9):
                assert tpre.evictable(ts, jid, when) == \
                    rpre.evictable(rs, jid, when)
        # a started entry is truncated; the residual is re-placed
        rs.advance_to(t)
        ts.advance_to(t)
        r_res = rpre.evict(rs, 0, t, 1.5)
        t_res = tpre.evict(ts, 0, t, 1.5)
        assert dataclasses.asdict(t_res) == dataclasses.asdict(r_res)
        _assert_states_equal(rs, ts)
        assert tpre.replace(ts, t_res, np.arange(4, 10), 1e6, 1.5) == \
            rpre.replace(rs, r_res, np.arange(4, 10), 1e6, 1.5)
        _assert_states_equal(rs, ts)
        # a never-started entry is removed outright
        late = max(rs.est_start.items(), key=lambda kv: kv[1])[0]
        assert dataclasses.asdict(tpre.evict(ts, late, t, 1.5)) == \
            dataclasses.asdict(rpre.evict(rs, late, t, 1.5))
        _assert_states_equal(rs, ts)
        # an elastic resize, then one refused by a tight budget
        for theta in (1e6, 1e-3):
            assert tpre.resize(ts, 1, t, 1, np.array([11]), theta, 1.5) == \
                rpre.resize(rs, 1, t, 1, np.array([11]), theta, 1.5)
            _assert_states_equal(rs, ts)
        # refusals: unknown job, less than one iteration left
        assert tpre.evict(ts, 99, t, 1.5) is None
        assert tpre.evict(ts, 3, 1e12, 1.5) is \
            rpre.evict(rs, 3, 1e12, 1.5) is None
        _assert_states_equal(rs, ts)

    def test_clone_drops_hooks(self):
        """A trial on a clone must not reach the live state's journal."""
        (_, _), (ts, _) = self._states("batched")
        seen = []
        ts.commit_hook = lambda *a: seen.append("commit")
        ts.evict_hook = lambda *a: seen.append("evict")
        trial = ts.clone()
        tpre.evict(trial, 0, 1.0, 1.5)
        assert seen == [] and trial.commit_hook is trial.evict_hook is None
        tpre.evict(ts, 0, 1.0, 1.5)
        assert seen == ["evict"]


class TestEngineEquivalence:
    @pytest.mark.parametrize("engine", ENGINES)
    @pytest.mark.parametrize("policy,trace", TRACES)
    def test_online_schedules_match_reference(self, policy, trace, engine):
        want, got = _both(policy, trace, engine)
        _assert_schedules_equal(want, got)

    @pytest.mark.parametrize("engine", ENGINES)
    @pytest.mark.parametrize("policy", ["sjf-bco-dynamic", "wang-ca",
                                        "gadget-elastic"])
    def test_batch_schedules_match_reference(self, policy, engine):
        cluster = rc.philly_cluster(6, seed=3)
        jobs = [dataclasses.replace(j, jid=i) for i, j in
                enumerate(rc.philly_workload(seed=3)[:24])]
        want = rc.get_policy(policy)(rc.ScheduleRequest(
            cluster=cluster, jobs=jobs, horizon=1200,
            params={"engine": engine}))
        p_cluster, p_jobs = _carry(cluster, jobs)
        got = tc.get_policy(policy)(tc.ScheduleRequest(
            cluster=p_cluster, jobs=p_jobs, horizon=1200,
            params={"engine": engine}))
        _assert_schedules_equal(want, got)

    @pytest.mark.parametrize("hetero", [False, True])
    @pytest.mark.parametrize("policy", ["sjf-bco-dynamic", "wang-ca"])
    def test_card_configuration_on_cpu(self, policy, hetero):
        """What ``run_scenario(..., device="cuda")`` sets (columnar
        placement, the kernel backends), run on the plain versions, with
        the batched and the incremental engine."""
        cluster = rc.philly_cluster(5, seed=2, **(HETERO if hetero else {}))
        jobs = [dataclasses.replace(j, jid=i) for i, j in
                enumerate(rc.philly_workload(seed=2)[:20])]
        p_cluster, p_jobs = _carry(cluster, jobs)
        for engine in ("batched", "incremental"):
            want = rc.get_policy(policy)(rc.ScheduleRequest(
                cluster=cluster, jobs=jobs, horizon=1200,
                params={"engine": engine}))
            before = launch_counts()
            with tau_backend("kernel", device="cpu"):
                got = tc.get_policy(policy)(tc.ScheduleRequest(
                    cluster=p_cluster, jobs=p_jobs, horizon=1200,
                    params={"engine": engine, "placement": "columnar",
                            "columnar_backend": "kernel",
                            "device": "cpu"}))
            assert launch_counts() == before
            _assert_schedules_equal(want, got)

    @pytest.mark.parametrize("hetero", [False, True])
    def test_run_scenario_dynamic_matches_reference(self, hetero):
        def build(mod):
            return mod.Scenario(
                cluster=mod.ClusterSpec(num_servers=5, seed=3,
                                        **(HETERO if hetero else {})),
                workload=mod.WorkloadSpec(num_jobs=24, seed=3),
                policy="sjf-bco-dynamic", horizon=1200)
        want = rc.run_scenario(build(rc))
        got = tc.run_scenario(build(tc), device="cpu")
        _assert_schedules_equal(want.schedule, got.schedule)
        _assert_sims_equal(want.sim, got.sim)
        assert dataclasses.astuple(want.contention) == \
            dataclasses.astuple(got.contention)

    def test_dynamic_trace_actually_preempts(self):
        want, got = _both("sjf-bco-dynamic", _evict_trace)
        cluster, jobs, arrivals, _ = _evict_trace(tc)
        assert got.quotas is not None
        assert len(got.assignment) > len(jobs)
        sim = tc.simulate(cluster, jobs, got.assignment, arrivals=arrivals,
                          quotas=got.quotas)
        assert sim.completed == len(jobs)
        base = tc.get_policy("sjf-bco")(tc.ScheduleRequest(
            cluster=cluster, jobs=jobs, arrivals=arrivals, horizon=10**6))
        assert sim.avg_jct < tc.simulate(cluster, jobs, base.assignment,
                                         arrivals=arrivals).avg_jct
        r_cluster, r_jobs, _, _ = _evict_trace(rc)
        _assert_sims_equal(sim, rc.simulate(r_cluster, r_jobs,
                                            want.assignment,
                                            arrivals=arrivals,
                                            quotas=want.quotas))

    def test_elastic_trace_actually_resizes(self):
        want, got = _both("gadget-elastic", _resize_trace)
        cluster, jobs, arrivals, _ = _resize_trace(tc)
        assert got.quotas is not None
        widths = {j: len(g) for j, g in got.assignment}
        assert widths[0] < jobs[0].num_gpus
        sim = tc.simulate(cluster, jobs, got.assignment, arrivals=arrivals,
                          quotas=got.quotas)
        assert sim.completed == len(jobs)

    def test_chooser_is_the_policy_online_path(self):
        cluster, jobs, arrivals, horizon = _evict_trace(tc)
        request = tc.ScheduleRequest(cluster=cluster, jobs=jobs,
                                     arrivals=arrivals, horizon=horizon)
        from repro_torch.core.api import get_chooser, schedule_arrivals
        via_loop = schedule_arrivals(
            request, get_chooser("sjf-bco-dynamic")(cluster, 1.5, {}),
            "SJF-BCO-DYN")
        _assert_schedules_equal(tc.get_policy("sjf-bco-dynamic")(request),
                                via_loop)


class TestSimulatorAxesOnSegments:
    def _segmented(self):
        want, got = _both("sjf-bco-dynamic", _evict_trace)
        cluster, jobs, arrivals, _ = _evict_trace(tc)
        r_cluster, r_jobs, _, _ = _evict_trace(rc)
        oracle = rc.simulate(r_cluster, r_jobs, want.assignment,
                             arrivals=arrivals, quotas=want.quotas,
                             engine="reference", readiness="rescan")
        return cluster, jobs, arrivals, got, oracle

    @pytest.mark.parametrize("engine,readiness,stepping", [
        ("reference", "tracked", "single"), ("reference", "rescan", "single"),
        ("incremental", "tracked", "single"),
        ("incremental", "rescan", "single"),
        ("incremental", "tracked", "multi")])
    def test_segmented_schedule_identical_across_axes(self, engine,
                                                      readiness, stepping):
        cluster, jobs, arrivals, sched, oracle = self._segmented()
        sim = tc.simulate(cluster, jobs, sched.assignment, arrivals=arrivals,
                          quotas=sched.quotas, engine=engine,
                          readiness=readiness, stepping=stepping)
        _assert_sims_equal(oracle, sim)

    def test_quota_guard_rejects_unlabelled_segments(self):
        cluster, jobs, arrivals, sched, _ = self._segmented()
        with pytest.raises(ValueError, match="must pass quotas"):
            tc.simulate(cluster, jobs, sched.assignment, arrivals=arrivals)


def _drain(pkg, policy, trace):
    Dmn, Q, T = pkg
    mod = rc if Dmn is RDaemon else tc
    cluster, jobs, arrivals, horizon = trace(mod)
    kw = {} if Dmn is RDaemon else {"device": "cpu"}
    daemon = Dmn(cluster, None, Q(default=T(policy=policy)),
                 horizon=horizon, **kw)
    for job, a in zip(jobs, arrivals):
        daemon.admit(job, arrival=int(a))
    sched, sim = daemon.drain()
    return daemon, sched, sim


REF = (RDaemon, RQueue, RTenant)
PORT = (Daemon, QueueManager, TenantConfig)


def _journal(store):
    return [(e.seq, e.ts, e.kind, e.jid, e.to_json())
            for e in store.entries()]


class TestDaemonEquivalence:
    @pytest.mark.parametrize("policy,trace", TRACES)
    def test_daemon_matches_reference_daemon(self, policy, trace):
        r_daemon, r_sched, r_sim = _drain(REF, policy, trace)
        daemon, sched, sim = _drain(PORT, policy, trace)
        _assert_schedules_equal(r_sched, sched)
        _assert_sims_equal(r_sim, sim)
        assert _journal(daemon.store) == _journal(r_daemon.store)
        cluster, jobs, arrivals, horizon = trace(tc)
        oneshot = tc.get_policy(policy)(tc.ScheduleRequest(
            cluster=cluster, jobs=jobs, arrivals=arrivals, horizon=horizon))
        assert [j for j, _ in oneshot.assignment] == \
            [j for j, _ in sched.assignment]
        assert np.array_equal(oneshot.quotas if oneshot.quotas is not None
                              else [], sched.quotas if sched.quotas
                              is not None else [])

    @pytest.mark.parametrize("policy,trace,kind", [
        ("sjf-bco-dynamic", _evict_trace, "evict"),
        ("gadget-elastic", _resize_trace, "resize")])
    def test_recovery_identical_at_every_prefix(self, policy, trace, kind):
        daemon, full, _ = _drain(PORT, policy, trace)
        cluster, jobs, arrivals, horizon = trace(tc)
        entries = daemon.store.entries()
        assert kind in [e.kind for e in entries]
        for k in range(len(entries) + 1):
            for compact in (False, True):
                snap = daemon.store.prefix(k)
                if compact:
                    snap.snapshot()
                again = Daemon.recover(
                    cluster, snap, QueueManager(TenantConfig(policy)),
                    horizon=horizon, device="cpu")
                for job, a in list(zip(jobs, arrivals))[len(again.jobs):]:
                    again.admit(job, arrival=int(a))
                sched, _ = again.drain()
                _assert_schedules_equal(full, sched)

    def test_recover_then_crash_then_recover(self):
        daemon, full, _ = _drain(PORT, "sjf-bco-dynamic", _evict_trace)
        cluster, jobs, arrivals, horizon = _evict_trace(tc)
        entries = daemon.store.entries()
        k = next(i for i in range(1, len(entries))
                 if entries[i - 1].kind == "evict")
        first = Daemon.recover(cluster, daemon.store.prefix(k),
                               QueueManager(TenantConfig("sjf-bco-dynamic")),
                               horizon=horizon, device="cpu")
        for job, a in list(zip(jobs, arrivals))[len(first.jobs):]:
            first.admit(job, arrival=int(a))
        first.drain()
        again = Daemon.recover(cluster, first.store,
                               QueueManager(TenantConfig("sjf-bco-dynamic")),
                               horizon=horizon, device="cpu")
        sched, _ = again.drain()
        _assert_schedules_equal(full, sched)

    @pytest.mark.parametrize("policy", ["sjf-bco-dynamic", "gadget-elastic",
                                        "wang-ca"])
    def test_hetero_stream_matches_reference(self, policy):
        cluster = rc.philly_cluster(4, seed=6, **HETERO)
        jobs = [dataclasses.replace(j, jid=i) for i, j in
                enumerate(rc.philly_workload(seed=6)[:24])]
        arrivals = np.sort(np.random.default_rng(6).integers(
            0, 80, size=len(jobs))).astype(np.int64)
        r_daemon = RDaemon(cluster, None, RQueue(RTenant(policy)),
                           horizon=600)
        p_cluster, p_jobs = _carry(cluster, jobs)
        daemon = Daemon(p_cluster, None, QueueManager(TenantConfig(policy)),
                        horizon=600, device="cpu")
        for rj, pj, a in zip(jobs, p_jobs, arrivals):
            r_daemon.admit(rj, int(a))
            daemon.admit(pj, int(a))
        r_sched, r_sim = r_daemon.drain()
        sched, sim = daemon.drain()
        _assert_schedules_equal(r_sched, sched)
        _assert_sims_equal(r_sim, sim)
        assert _journal(daemon.store) == _journal(r_daemon.store)
        assert isinstance(daemon.store, MemoryStore)
