"""The port's §6 theory certificate and arrival-stream helpers against the
JAX reference, bit for bit.

The same seeded instances (numpy seeds; no shared hypothesis database)
go through ``repro.core.theory`` / ``repro.core.online`` and their
copies in ``repro_torch.core``; every :class:`TheoryReport` field, every
stream and every online schedule and simulation must be equal.  The
certificates are held on homogeneous clusters only: the reference's
``tau_bounds`` is not an upper bound on mixed clusters.  The online cases
are those of ``tests/test_online.py``'s scheduling class, each run on
both sides.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.online as ronline
import repro.core.theory as rtheory
import repro_torch.core as tc
import repro_torch.core.online as tonline
import repro_torch.core.theory as ttheory
from repro_torch.convert import from_reference
from repro_torch.core.contention import tau_backend
from repro_torch.kernels import launch_counts


def _carry(cluster, jobs):
    return from_reference(cluster.to_payload(),
                          [dataclasses.asdict(j) for j in jobs])


def _instance(seed):
    """A homogeneous instance drawn like ``tests/test_theory.py``'s
    strategy: 2-6 servers of 4/8/16 GPUs, 1-12 jobs."""
    rng = np.random.default_rng(seed)
    caps = tuple(int(c) for c in rng.choice([4, 8, 16],
                                            size=rng.integers(2, 7)))
    cluster = rc.Cluster(capacities=caps)
    jobs = []
    for i in range(int(rng.integers(1, 13))):
        jobs.append(rc.Job(
            jid=i, num_gpus=min(int(rng.choice([1, 2, 4, 8])),
                                cluster.num_gpus),
            iters=int(rng.integers(200, 3001)),
            grad_size=float(rng.uniform(5e-4, 2e-3)),
            batch=int(rng.integers(8, 65)),
            dt_fwd=float(rng.uniform(2e-4, 5e-4)),
            dt_bwd=float(rng.uniform(4e-3, 1.2e-2))))
    return cluster, jobs


def _sjf_and_sim(mod, cluster, jobs, arrivals=None):
    sched = mod.get_policy("sjf-bco")(mod.ScheduleRequest(
        cluster=cluster, jobs=jobs, horizon=20000, arrivals=arrivals))
    return sched, mod.simulate(cluster, jobs, sched.assignment,
                               arrivals=arrivals)


def _assert_sims_equal(a, b):
    assert a.makespan == b.makespan and a.avg_jct == b.avg_jct
    assert a.avg_queueing_delay == b.avg_queueing_delay
    assert a.completed == b.completed
    assert np.array_equal(a.start, b.start)
    assert np.array_equal(a.finish, b.finish)
    assert [dataclasses.astuple(e) for e in a.events] == \
        [dataclasses.astuple(e) for e in b.events]


def _assert_assignments_equal(a, b):
    assert len(a) == len(b)
    for (j1, g1), (j2, g2) in zip(a, b):
        assert j1 == j2 and np.array_equal(g1, g2)


class TestTheory:
    @pytest.mark.parametrize("seed", range(8))
    def test_report_fields_match_reference(self, seed):
        cluster, jobs = _instance(seed)
        sched, sim = _sjf_and_sim(rc, cluster, jobs)
        want = rtheory.report(cluster, jobs, sched, sim)
        p_cluster, p_jobs = _carry(cluster, jobs)
        p_sched, p_sim = _sjf_and_sim(tc, p_cluster, p_jobs)
        got = ttheory.report(p_cluster, p_jobs, p_sched, p_sim)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.certified and want.certified
        assert ttheory.empirical_brackets(p_cluster, p_jobs, p_sim) == \
            rtheory.empirical_brackets(cluster, jobs, sim)

    def test_explicit_varphi_and_section7_certificate(self):
        """The §7 cluster with an arrival stream (a homogeneous run the
        card phase also certifies), with the default and a given varphi."""
        cluster = rc.philly_cluster(20, seed=1)
        jobs = rc.philly_workload(seed=1)
        stream = ronline.poisson_arrivals(jobs, rate=0.5, seed=1)
        req = ronline.stream_request(cluster, stream)
        sched, sim = _sjf_and_sim(rc, cluster, req.jobs, req.arrivals)
        p_cluster, p_jobs = _carry(cluster, req.jobs)
        p_sched, p_sim = _sjf_and_sim(tc, p_cluster, p_jobs, req.arrivals)
        for varphi in (None, 1.25):
            want = rtheory.report(cluster, req.jobs, sched, sim, varphi)
            got = ttheory.report(p_cluster, p_jobs, p_sched, p_sim, varphi)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert got.certified == want.certified
        assert tc.report is ttheory.report
        assert tc.TheoryReport is ttheory.TheoryReport


class TestStreams:
    @pytest.mark.parametrize("rate,seed", [(0.2, 1), (0.5, 1), (2.0, 3),
                                           (50.0, 2)])
    def test_poisson_arrivals_and_request(self, rate, seed):
        jobs = rc.philly_workload(seed=seed)
        want = ronline.poisson_arrivals(jobs, rate=rate, seed=seed)
        p_jobs = tc.philly_workload(seed=seed)
        got = tonline.poisson_arrivals(p_jobs, rate=rate, seed=seed)
        assert [(dataclasses.asdict(a.job), a.arrival) for a in got] == \
            [(dataclasses.asdict(a.job), a.arrival) for a in want]
        cluster = rc.philly_cluster(4, seed=seed)
        p_cluster = tc.philly_cluster(4, seed=seed)
        r_req = ronline.stream_request(cluster, want, horizon=777, u=1.25,
                                       params={"engine": "batched"})
        p_req = tonline.stream_request(p_cluster, got, horizon=777, u=1.25,
                                       params={"engine": "batched"})
        assert [dataclasses.asdict(j) for j in p_req.jobs] == \
            [dataclasses.asdict(j) for j in r_req.jobs]
        assert np.array_equal(p_req.arrivals, r_req.arrivals)
        assert p_req.arrivals.dtype == r_req.arrivals.dtype
        assert (p_req.horizon, p_req.u, p_req.params) == \
            (r_req.horizon, r_req.u, r_req.params)


def _ref_online(cluster, stream, policy):
    """The reference's ``run_online``, with the segments' quotas passed to
    the simulator (its own ``run_online`` omits them and raises on a
    preempted schedule)."""
    request = ronline.stream_request(cluster, stream)
    sched = rc.get_policy(policy)(request)
    return sched.assignment, rc.simulate(cluster, request.jobs,
                                         sched.assignment,
                                         arrivals=request.arrivals,
                                         quotas=sched.quotas)


def _online_both(rate, seed=1, servers=20, n=None, policy="sjf-bco"):
    jobs = rc.philly_workload(seed=seed)[:n]
    cluster = rc.philly_cluster(servers, seed=seed)
    stream = ronline.poisson_arrivals(jobs, rate=rate, seed=seed)
    want = _ref_online(cluster, stream, policy)
    if policy in ("sjf-bco", "ff", "ls", "reserved"):
        plain = ronline.run_online(cluster, stream, policy=policy)
        _assert_assignments_equal(plain[0], want[0])
        _assert_sims_equal(plain[1], want[1])
    p_cluster = tc.philly_cluster(servers, seed=seed)
    p_stream = tonline.poisson_arrivals(tc.philly_workload(seed=seed)[:n],
                                        rate=rate, seed=seed)
    got = tonline.run_online(p_cluster, p_stream, policy=policy,
                             device="cpu")
    _assert_assignments_equal(got[0], want[0])
    _assert_sims_equal(got[1], want[1])
    return stream, got


class TestOnlineScheduling:
    """``tests/test_online.py``'s scheduling cases, each on both sides."""

    @pytest.mark.parametrize("rate", [0.2, 0.5, 2.0])
    def test_all_jobs_complete_after_their_arrival(self, rate):
        stream, (_, sim) = _online_both(rate)
        assert sim.completed == len(stream)
        for a in stream:
            assert sim.start[a.job.jid] >= a.arrival

    def test_high_rate_and_low_rate(self):
        _, (_, fast) = _online_both(50.0)
        cluster = tc.philly_cluster(20, seed=1)
        jobs = tc.philly_workload(seed=1)
        offline = tc.simulate(cluster, jobs, tc.get_policy("sjf-bco")(
            tc.ScheduleRequest(cluster=cluster, jobs=jobs,
                               horizon=1200)).assignment).makespan
        assert fast.makespan < 2.5 * offline
        stream, (_, slow) = _online_both(0.2)
        last = max(a.arrival for a in stream)
        assert last <= slow.makespan < last + 400

    @pytest.mark.parametrize("policy", ["sjf-bco", "ff", "ls", "reserved",
                                        "sjf-bco-dynamic", "gadget-elastic",
                                        "wang-ca"])
    def test_run_online_policies(self, policy):
        _, (asg, sim) = _online_both(0.5, seed=2, servers=4, n=20,
                                     policy=policy)
        assert sim.completed == 20
        for _, gpus in asg:
            assert len(np.unique(gpus)) == len(gpus)

    def test_every_policy_handles_arrivals(self):
        cluster = rc.philly_cluster(6, seed=3)
        jobs = [dataclasses.replace(j, jid=i) for i, j in
                enumerate(rc.philly_workload(seed=3)[:24])]
        arrivals = np.arange(len(jobs), dtype=np.int64) * 2
        p_cluster, p_jobs = _carry(cluster, jobs)
        assert tc.list_policies() == rc.list_policies()
        for name in tc.list_policies():
            want = rc.get_policy(name)(rc.ScheduleRequest(
                cluster=cluster, jobs=jobs, arrivals=arrivals,
                horizon=10**6))
            got = tc.get_policy(name)(tc.ScheduleRequest(
                cluster=p_cluster, jobs=p_jobs, arrivals=arrivals,
                horizon=10**6))
            _assert_assignments_equal(got.assignment, want.assignment)
            assert np.array_equal(got.est_finish, want.est_finish), name
            sim = tc.simulate(p_cluster, p_jobs, got.assignment,
                              arrivals=arrivals, quotas=got.quotas)
            _assert_sims_equal(sim, rc.simulate(
                cluster, jobs, want.assignment, arrivals=arrivals,
                quotas=want.quotas))
            assert sim.completed == len(jobs), name
            assert np.all(sim.start >= arrivals), name

    @pytest.mark.parametrize("arrivals", [(0, 500), (0, 1, 500)])
    def test_jct_queueing_and_idle_windows(self, arrivals):
        arrivals = np.array(arrivals)
        sims = []
        for mod in (rc, tc):
            jobs = [mod.Job(jid=i, num_gpus=2, iters=100, grad_size=1e-3,
                            batch=32, dt_fwd=3e-4, dt_bwd=8e-3)
                    for i in range(len(arrivals))]
            asg = [(i, np.arange(2)) for i in range(len(arrivals))]
            cluster = mod.Cluster(capacities=(2,))
            sims.append((mod.simulate(cluster, jobs, asg, arrivals=arrivals),
                         mod.simulate(cluster, jobs, asg)))
        (want, want_b), (got, got_b) = sims
        _assert_sims_equal(got, want)
        _assert_sims_equal(got_b, want_b)
        assert got.avg_jct == pytest.approx(
            (got.finish - arrivals).astype(float).mean())
        assert sum(e.dt for e in got.events) == got.makespan
        assert any(e.active == 0 for e in got.events)
        assert dataclasses.astuple(tc.ContentionStats.from_sim(got)) == \
            dataclasses.astuple(rc.ContentionStats.from_sim(want))

    def test_run_report_exposes_queueing_delay(self):
        reps = [mod.run_scenario(mod.Scenario(
            cluster=mod.ClusterSpec(num_servers=4, seed=2),
            workload=mod.WorkloadSpec(seed=2, num_jobs=12),
            arrivals=mod.ArrivalSpec(rate=0.2, seed=2)),
            **({"device": "cpu"} if mod is tc else {})) for mod in (rc, tc)]
        assert reps[1].avg_queueing_delay == reps[0].avg_queueing_delay
        assert reps[1].avg_queueing_delay == reps[1].sim.avg_queueing_delay
        assert not hasattr(tonline, "schedule_online")


class TestCardConfigurationOnCpu:
    """What ``run_online`` sets on a CUDA device (batched engine, columnar
    placement, the kernel backends), run on the kernels' plain versions."""

    @pytest.mark.parametrize("hetero", [False, True])
    @pytest.mark.parametrize("policy", ["sjf-bco", "sjf-bco-dynamic",
                                        "gadget-elastic", "wang-ca"])
    def test_card_params_match_reference(self, policy, hetero):
        kw = dict(speed_tiers=((50.0, 0.5), (12.5, 0.5)),
                  link_classes=((1.25, "shared", 0.5),
                                (1.25, "isolated", 0.5))) if hetero else {}
        cluster = rc.philly_cluster(5, seed=4, **kw)
        jobs = rc.philly_workload(seed=4)[:30]
        stream = ronline.poisson_arrivals(jobs, rate=0.5, seed=4)
        want = _ref_online(cluster, stream, policy)
        p_cluster, _ = _carry(cluster, jobs)
        p_stream = tonline.poisson_arrivals(tc.philly_workload(seed=4)[:30],
                                            rate=0.5, seed=4)
        request = tonline.stream_request(p_cluster, p_stream, params={
            "engine": "batched", "placement": "columnar",
            "columnar_backend": "kernel", "device": "cpu"})
        before = launch_counts()
        with tau_backend("kernel", device="cpu"):
            got = tc.get_policy(policy)(request)
        assert launch_counts() == before     # plain versions launch nothing
        _assert_assignments_equal(got.assignment, want[0])
        sim = tc.simulate(p_cluster, request.jobs, got.assignment,
                          arrivals=request.arrivals, quotas=got.quotas)
        _assert_sims_equal(sim, want[1])

    def test_cuda_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        stream = tonline.poisson_arrivals(tc.philly_workload(seed=0)[:4])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tonline.run_online(tc.philly_cluster(2, seed=0), stream)
