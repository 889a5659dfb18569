"""The port's scheduler service against the JAX reference's, bit for bit.

``repro_torch.service`` is held to ``repro.service`` on the same seeded
streams: the state machine, both journal stores and the queue manager;
the daemon's drain for every registered policy (schedule, simulation and
the journal itself, entry for entry); crash recovery at every journal
prefix, with snapshot compaction and RAND's rng; journals written by one
package's daemon and recovered by the other's; ``replay_trace`` over
``examples/sample_trace.csv``; and the card's configuration (batched
engine, ``tau_backend("kernel")``) run on the kernels' plain versions.
Every port daemon here runs with ``device="cpu"``.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.service as rs
import repro_torch.core as tc
import repro_torch.service as ts
from repro.core.trace import replay_trace as r_replay_trace
from repro_torch.convert import from_reference
from repro_torch.core import contention
from repro_torch.core.contention import tau_backend
from repro_torch.core.trace import replay_trace
from repro_torch.kernels import launch_counts

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRACE = ROOT / "examples" / "sample_trace.csv"
HETERO = dict(speed_tiers=((50.0, 0.5), (12.5, 0.5)),
              link_classes=((1.25, "shared", 0.5), (1.25, "isolated", 0.5)))
POLICIES = [("sjf-bco", {}), ("ff", {}), ("ls", {}), ("rand", {"seed": 7}),
            ("reserved", {}), ("sjf-bco-adaptive", {}),
            ("sjf-bco-dynamic", {}), ("gadget-elastic", {}), ("wang-ca", {})]


def _case(n=24, servers=8, hi=120, hetero=False):
    """(reference cluster, reference jobs, port cluster, port jobs,
    arrivals): one seeded stream on both sides."""
    cluster = rc.philly_cluster(servers, seed=1, **(HETERO if hetero else {}))
    jobs = [dataclasses.replace(j, jid=i) for i, j in
            enumerate(rc.philly_workload(seed=3)[:n])]
    arrivals = np.sort(np.random.default_rng(0).integers(
        0, hi, size=n)).astype(np.int64)
    p_cluster, p_jobs = from_reference(cluster.to_payload(),
                                       [dataclasses.asdict(j) for j in jobs])
    return cluster, jobs, p_cluster, p_jobs, arrivals


def _submit(svc, mod, jobs, arrivals, tenant="default"):
    for job, a in zip(jobs, arrivals):
        svc.submit(mod.SubmitRequest(job, int(a), tenant))


def _assert_schedules_equal(a, b):
    assert np.array_equal(a.est_start, b.est_start)
    assert np.array_equal(a.est_finish, b.est_finish)
    assert len(a.assignment) == len(b.assignment)
    for (j1, g1), (j2, g2) in zip(a.assignment, b.assignment):
        assert j1 == j2 and np.array_equal(g1, g2)
    assert (a.quotas is None) == (b.quotas is None)
    if a.quotas is not None:
        assert np.array_equal(a.quotas, b.quotas)
    assert (a.theta, a.kappa, a.policy) == (b.theta, b.kappa, b.policy)


def _assert_sims_equal(a, b):
    assert np.array_equal(a.start, b.start)
    assert np.array_equal(a.finish, b.finish)
    assert (a.makespan, a.avg_jct, a.completed) == \
        (b.makespan, b.avg_jct, b.completed)
    assert [dataclasses.astuple(e) for e in a.events] == \
        [dataclasses.astuple(e) for e in b.events]


def _journal(store):
    return [(e.seq, e.ts, e.kind, e.jid, e.to_json())
            for e in store.entries()]


def _assert_daemons_equal(a, b):
    """Clocks, records, rounds and virtual time, bit for bit."""
    assert np.array_equal(a.state.U, b.state.U)
    assert np.array_equal(a.state.R, b.state.R)
    assert a.state.est_start == b.state.est_start
    assert a.state.est_finish == b.state.est_finish
    assert a.state.seg_quota == b.state.seg_quota
    assert a.rounds == b.rounds and a.clock.now() == b.clock.now()
    assert sorted(a.records) == sorted(b.records)
    for jid, ra in a.records.items():
        rb = b.records[jid]
        assert ra.state.value == rb.state.value and ra.tenant == rb.tenant
        assert (ra.rho, ra.start, ra.finish, ra.arrival) == \
            (rb.rho, rb.start, rb.finish, rb.arrival)
        assert dataclasses.asdict(ra.job) == dataclasses.asdict(rb.job)
        assert (ra.gpus is None) == (rb.gpus is None)
        if ra.gpus is not None:
            assert np.array_equal(ra.gpus, rb.gpus)


class TestStateMachine:
    def test_transitions_match_reference(self):
        assert {k.value: sorted(s.value for s in v)
                for k, v in ts.TRANSITIONS.items()} == \
            {k.value: sorted(s.value for s in v)
             for k, v in rs.TRANSITIONS.items()}
        assert sorted(s.value for s in ts.TERMINAL) == \
            sorted(s.value for s in rs.TERMINAL)
        assert ts.__all__ == rs.__all__

    def test_lifecycle_and_illegal_moves(self):
        job = tc.philly_workload(seed=3)[0]
        rec = ts.JobRecord(jid=0, tenant="t", job=job, arrival=0)
        for state in (ts.JobState.QUEUED, ts.JobState.PLACING):
            rec.advance(state)
        rec.gpus, rec.rho, rec.start = np.arange(2), 3.0, 1.0
        rec.advance(ts.JobState.QUEUED)          # the crash re-enqueue
        assert rec.gpus is None and rec.rho is None and rec.start is None
        for state in (ts.JobState.PLACING, ts.JobState.RUNNING,
                      ts.JobState.QUEUED, ts.JobState.PLACING,
                      ts.JobState.RUNNING, ts.JobState.DONE):
            rec.advance(state)
        with pytest.raises(ts.InvalidTransition):
            rec.advance(ts.JobState.QUEUED)      # terminal
        fresh = ts.JobRecord(jid=1, tenant="t", job=job, arrival=0)
        with pytest.raises(ts.InvalidTransition):
            fresh.advance(ts.JobState.RUNNING)


class TestStores:
    def test_memory_prefix_seq_and_snapshot(self):
        store = ts.MemoryStore()
        for i in range(5):
            assert store.append("transition", i, {"to": "QUEUED"},
                                ts=float(i)).seq == i + 1
        snap = store.prefix(3)
        snap.append("advance", -1, {"t": 9})
        assert len(store) == 5 and len(snap) == 4
        assert store.snapshot() == 0             # no cluster record

    def test_sqlite_formats_match_reference(self, tmp_path):
        """The same appends give the same table, rows and payload text."""
        payloads = [("cluster", -1, tc.philly_cluster(
            3, seed=1, **HETERO).to_payload()),
            ("transition", 7, {"to": "RUNNING", "gpus": [3, 4],
                               "rho": 0.1 + 0.2, "start": 17.0}),
            ("transition", 8, {"to": "DONE", "finish": 5,
                               "rng": np.random.default_rng(
                                   3).bit_generator.state}),
            ("evict", 2, {"t": 1 / 3, "iters": 2999.0000000000005,
                          "num_gpus": 4})]
        dbs = []
        for mod, name in ((rs, "ref.db"), (ts, "port.db")):
            store = mod.SqliteStore(str(tmp_path / name))
            for kind, jid, payload in payloads:
                store.append(kind, jid, payload, ts=1.5)
            store.close()
            dbs.append(mod.SqliteStore(str(tmp_path / name)))
        ref, port = dbs
        assert ref._db.execute("SELECT sql FROM sqlite_master").fetchall() \
            == port._db.execute("SELECT sql FROM sqlite_master").fetchall()
        rows = "SELECT seq, ts, kind, jid, payload FROM journal"
        assert ref._db.execute(rows).fetchall() == \
            port._db.execute(rows).fetchall()
        assert [e.payload for e in port.entries()] == \
            [json.loads(json.dumps(p)) for _, _, p in payloads]
        assert port.entries()[1].payload["rho"] == 0.1 + 0.2
        ref.close()
        port.close()
        assert isinstance(ts.open_store(None), ts.MemoryStore)


class TestQueueManager:
    def test_visit_order_batches_and_cancel(self):
        jobs = tc.philly_workload(seed=3)[:6]
        jobs = [dataclasses.replace(j, jid=i) for i, j in enumerate(jobs)]
        order = [(5, 0), (1, 3), (1, 1), (0, 2), (1, 5), (0, 4)]
        popped = []
        for mod, wrap in ((rs, rc), (ts, tc)):
            mod_jobs = [wrap.Job(**dataclasses.asdict(j)) for j in jobs]
            qm = mod.QueueManager(round_slots=2, max_batch=3)
            for arrival, jid in order:
                rec = mod.JobRecord(jid=jid, tenant="t", job=mod_jobs[jid],
                                    arrival=arrival)
                rec.advance(mod.JobState.QUEUED)
                qm.push(rec)
            assert qm.cancel(4) and not qm.cancel(4)
            batches = []
            while len(qm):
                batches.append([(r.arrival, r.job.num_gpus, r.jid)
                                for r in qm.next_batch()])
            popped.append(batches)
        assert popped[1] == popped[0]
        flat = [k for b in popped[1] for k in b]
        assert flat == sorted(flat) and 4 not in [k[2] for k in flat]
        with pytest.raises(ValueError, match="round_slots"):
            ts.QueueManager(round_slots=0)


class TestDaemonIdentity:
    @pytest.mark.parametrize("policy,params", POLICIES)
    def test_drain_matches_reference_daemon(self, policy, params):
        cluster, jobs, p_cluster, p_jobs, arrivals = _case()
        ref = rs.SchedulerService(cluster, policy=policy, params=params)
        _submit(ref, rs, jobs, arrivals)
        r_sched, r_sim = ref.drain()
        svc = ts.SchedulerService(p_cluster, policy=policy, params=params,
                                  device="cpu")
        _submit(svc, ts, p_jobs, arrivals)
        sched, sim = svc.drain()
        _assert_schedules_equal(r_sched, sched)
        _assert_sims_equal(r_sim, sim)
        assert _journal(svc.daemon.store) == _journal(ref.daemon.store)
        _assert_daemons_equal(ref.daemon, svc.daemon)
        oneshot = rc.get_policy(policy)(rc.ScheduleRequest(
            cluster, jobs, arrivals=arrivals, horizon=1200,
            params=dict(params)))
        assert [j for j, _ in oneshot.assignment] == \
            [j for j, _ in sched.assignment]
        assert np.array_equal(oneshot.est_finish, sched.est_finish)
        assert len(svc.daemon.decision_latencies) == len(jobs)
        assert sim.completed == len(jobs)

    @pytest.mark.parametrize("policy", ["sjf-bco", "sjf-bco-dynamic",
                                        "gadget-elastic", "wang-ca"])
    def test_hetero_drain_matches_reference_daemon(self, policy):
        cluster, jobs, p_cluster, p_jobs, arrivals = _case(
            n=20, servers=5, hi=60, hetero=True)
        ref = rs.SchedulerService(cluster, policy=policy)
        _submit(ref, rs, jobs, arrivals)
        svc = ts.SchedulerService(p_cluster, policy=policy, device="cpu")
        _submit(svc, ts, p_jobs, arrivals)
        r_out, out = ref.drain(), svc.drain()
        _assert_schedules_equal(r_out[0], out[0])
        _assert_sims_equal(r_out[1], out[1])
        assert _journal(svc.daemon.store) == _journal(ref.daemon.store)

    def test_batching_knobs_tenants_cancel_status(self):
        cluster, jobs, p_cluster, p_jobs, arrivals = _case(n=16, hi=50)
        want = None
        for kw in ({}, {"round_slots": 5}, {"max_batch": 1},
                   {"round_slots": 7, "max_batch": 3}):
            svc = ts.SchedulerService(p_cluster, device="cpu", **kw)
            _submit(svc, ts, p_jobs, arrivals)
            sched, _ = svc.drain()
            if want is None:
                want = sched
            _assert_schedules_equal(want, sched)
        pair = []
        for mod, cl, jb in ((rs, cluster, jobs), (ts, p_cluster, p_jobs)):
            kw = {} if mod is rs else {"device": "cpu"}
            svc = mod.SchedulerService(
                cl, tenants={"be": mod.TenantConfig(policy="ff")}, **kw)
            handles = [svc.submit(mod.SubmitRequest(
                j, int(a), "be" if i % 3 == 0 else "default"))
                for i, (j, a) in enumerate(zip(jb, arrivals))]
            assert svc.cancel(handles[4]) and not svc.cancel(99)
            while svc.step():
                pass
            st = svc.status(handles[0])
            assert st.state.value in ("RUNNING", "DONE")
            assert not svc.cancel(handles[0])
            pair.append((svc.drain(), svc.table(), _journal(svc.daemon.store),
                         svc.status(handles[4], refresh=False)))
        (r_out, r_table, r_j, r_st), (out, table, j, st) = pair
        _assert_schedules_equal(r_out[0], out[0])
        assert table == r_table and j == r_j
        assert st.state is ts.JobState.CANCELLED
        assert dataclasses.astuple(st)[3:] == dataclasses.astuple(r_st)[3:]

    def test_feedback_actual_matches_reference(self):
        cluster, jobs, p_cluster, p_jobs, arrivals = _case(n=16, hi=200)
        ref = rs.SchedulerService(cluster, feedback="actual")
        _submit(ref, rs, jobs, arrivals)
        svc = ts.SchedulerService(p_cluster, feedback="actual", device="cpu")
        _submit(svc, ts, p_jobs, arrivals)
        r_out, out = ref.drain(), svc.drain()
        _assert_schedules_equal(r_out[0], out[0])
        _assert_sims_equal(r_out[1], out[1])
        assert np.all(out[1].start >= arrivals)
        with pytest.raises(ValueError, match="feedback"):
            ts.SchedulerService(p_cluster, feedback="oracle", device="cpu")


def _recovered(mod, cluster, store, policy="sjf-bco", params=(), **kw):
    cfg = mod.TenantConfig(policy, params=tuple(params))
    if mod is ts:
        kw.setdefault("device", "cpu")
    return mod.Daemon.recover(cluster, store, mod.QueueManager(cfg), **kw)


class TestCrashRecovery:
    @pytest.mark.parametrize("policy,params", [("sjf-bco", ()),
                                               ("rand", (("seed", 11),))])
    def test_every_journal_prefix_plain_and_compacted(self, policy, params):
        """Crash after every journaled event, recover (from the raw
        prefix and from its compaction) and finish the stream: the same
        schedule as the uninterrupted drain, and the recovered daemon's
        clocks equal to the reference's recovery of the same prefix."""
        cluster, jobs, p_cluster, p_jobs, arrivals = _case(n=14)
        svc = ts.SchedulerService(p_cluster, policy=policy,
                                  params=dict(params), device="cpu")
        _submit(svc, ts, p_jobs, arrivals)
        full, _ = svc.drain()
        store = svc.daemon.store
        folded = 0
        for k in range(len(store) + 1):
            ref_entries = [rs.JournalEntry(**dataclasses.asdict(e))
                           for e in store.prefix(k).entries()]
            ref = _recovered(rs, cluster, rs.MemoryStore(ref_entries),
                             policy, params)
            for compact in (False, True):
                snap = store.prefix(k)
                if compact:
                    folded += snap.snapshot() > 0
                daemon = _recovered(ts, p_cluster, snap, policy, params)
                _assert_daemons_equal(ref, daemon)
                assert sorted(daemon._choosers) == sorted(ref._choosers)
                if policy == "rand" and ref._choosers:
                    assert daemon._choosers["default"].get_state() == \
                        ref._choosers["default"].get_state()
                for j, a in list(zip(p_jobs, arrivals))[len(daemon.jobs):]:
                    daemon.admit(j, int(a))
                sched, _ = daemon.drain()
                _assert_schedules_equal(full, sched)
        assert folded > 0

    def test_snapshot_payload_matches_reference(self):
        cluster, jobs, p_cluster, p_jobs, arrivals = _case(n=12)
        stores = []
        for mod, cl, jb in ((rs, cluster, jobs), (ts, p_cluster, p_jobs)):
            svc = mod.SchedulerService(
                cl, policy="sjf-bco-dynamic",
                **({} if mod is rs else {"device": "cpu"}))
            _submit(svc, mod, jb, arrivals)
            while svc.step():
                pass
            half = svc.daemon.store.prefix(len(svc.daemon.store) // 2 + 3)
            assert half.snapshot() > 0
            stores.append(half)
        assert _journal(stores[1]) == _journal(stores[0])

    @pytest.mark.parametrize("policy", ["sjf-bco", "rand", "sjf-bco-dynamic",
                                        "gadget-elastic"])
    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_journal_crosses_packages(self, tmp_path, policy, writer):
        """A sqlite journal one package's daemon wrote mid-stream is
        recovered by the other's (cluster from the journal alone): the
        clocks at the cut equal the writer's own recovery, and both
        finish the stream on the reference's uninterrupted schedule."""
        hetero = policy == "gadget-elastic"
        cluster, jobs, p_cluster, p_jobs, arrivals = _case(
            n=18, servers=6, hi=80, hetero=hetero)
        params = {"seed": 5} if policy == "rand" else {}
        ref = rs.SchedulerService(cluster, policy=policy, params=params)
        _submit(ref, rs, jobs, arrivals)
        want, want_sim = ref.drain()
        src, dst = (rs, ts) if writer == "reference" else (ts, rs)
        path = str(tmp_path / "journal.db")
        kw = {"device": "cpu"} if src is ts else {}
        svc = src.SchedulerService(
            cluster if src is rs else p_cluster, policy=policy,
            params=params, store_path=path, **kw)
        _submit(svc, src, (jobs if src is rs else p_jobs)[:12], arrivals[:12])
        for _ in range(5):
            svc.step()
        svc.close()                               # the process dies
        own = src.SchedulerService.recover(None, path, policy=policy,
                                           params=params, **kw)
        kw = {"device": "cpu"} if dst is ts else {}
        other = dst.SchedulerService.recover(None, path, policy=policy,
                                             params=params, **kw)
        _assert_daemons_equal(own.daemon, other.daemon)
        assert other.daemon.cluster.to_payload() == cluster.to_payload()
        for rec, jb in ((own, jobs if src is rs else p_jobs),
                        (other, jobs if dst is rs else p_jobs)):
            mod = rs if isinstance(rec, rs.SchedulerService) else ts
            for j, a in list(zip(jb, arrivals))[len(rec.daemon.jobs):]:
                rec.submit(mod.SubmitRequest(j, int(a)))
            sched, sim = rec.drain()
            _assert_schedules_equal(want, sched)
            _assert_sims_equal(want_sim, sim)
        _assert_daemons_equal(own.daemon, other.daemon)
        own.close()
        other.close()

    def test_cluster_mismatch_and_missing_record_raise(self):
        _, _, p_cluster, p_jobs, arrivals = _case(n=4)
        svc = ts.SchedulerService(p_cluster, device="cpu")
        _submit(svc, ts, p_jobs, arrivals)
        with pytest.raises(ValueError, match="disagrees"):
            _recovered(ts, tc.philly_cluster(3, seed=9),
                       svc.daemon.store.prefix(len(svc.daemon.store)))
        with pytest.raises(ValueError, match="no cluster record"):
            _recovered(ts, None, ts.MemoryStore())


class TestTraceReplay:
    @pytest.mark.parametrize("policy", ["sjf-bco", "sjf-bco-dynamic"])
    def test_replay_trace_matches_reference(self, policy):
        cluster = rc.philly_cluster(4, seed=2)
        p_cluster = tc.philly_cluster(4, seed=2)
        ref = rs.Daemon(cluster, None, rs.QueueManager(rs.TenantConfig(
            policy)), horizon=10**6)
        got = ts.Daemon(p_cluster, None, ts.QueueManager(ts.TenantConfig(
            policy)), horizon=10**6, device="cpu")
        r_recs = r_replay_trace(ref, str(TRACE))
        recs = replay_trace(got, str(TRACE))
        assert [(r.jid, r.arrival, dataclasses.asdict(r.job)) for r in recs] \
            == [(r.jid, r.arrival, dataclasses.asdict(r.job))
                for r in r_recs]
        r_out, out = ref.drain(), got.drain()
        _assert_schedules_equal(r_out[0], out[0])
        _assert_sims_equal(r_out[1], out[1])
        assert out[1].completed == len(recs)
        assert _journal(got.store) == _journal(ref.store)


class TestCardConfigurationOnCpu:
    """The card daemon's configuration -- batched engine, every decision
    priced through ``tau_backend("kernel")`` -- on the plain versions."""

    @pytest.mark.parametrize("hetero", [False, True])
    @pytest.mark.parametrize("policy", ["sjf-bco", "sjf-bco-dynamic",
                                        "gadget-elastic", "wang-ca"])
    def test_kernel_backend_drain_equals_default(self, policy, hetero):
        cluster, jobs, p_cluster, p_jobs, arrivals = _case(
            n=20, servers=6, hi=60, hetero=hetero)
        ref = rs.SchedulerService(cluster, policy=policy)
        _submit(ref, rs, jobs, arrivals)
        r_out = ref.drain()
        before = launch_counts()
        with tau_backend("kernel", device="cpu"):
            svc = ts.SchedulerService(p_cluster, policy=policy,
                                      engine="batched", device="cpu")
            _submit(svc, ts, p_jobs, arrivals)
            out = svc.drain()
        assert launch_counts() == before
        assert svc.daemon.state.engine == "batched"
        _assert_schedules_equal(r_out[0], out[0])
        _assert_sims_equal(r_out[1], out[1])
        assert _journal(svc.daemon.store) == _journal(ref.daemon.store)

    def test_cpu_daemon_keeps_the_reference_defaults(self):
        _, _, p_cluster, p_jobs, arrivals = _case(n=6)
        svc = ts.SchedulerService(p_cluster, device="cpu")
        assert svc.daemon.state.engine == contention.DEFAULT_ENGINE
        seen = []
        chooser = svc.daemon._chooser_for("default")
        svc.daemon._choosers["default"] = lambda *a: (
            seen.append(contention.TAU_BACKEND), chooser(*a))[1]
        _submit(svc, ts, p_jobs, arrivals)
        svc.drain()
        assert seen == ["numpy"] * len(p_jobs)

    def test_cuda_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        cluster = tc.philly_cluster(2, seed=0)
        for make in (lambda: ts.SchedulerService(cluster),
                     lambda: ts.Daemon(cluster),
                     lambda: ts.SchedulerService.recover(cluster, None)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
