"""The port's span-and-counter recorder (``repro_torch.obs``) on the CPU:
off by default, spans nested under their parents, self times that add
up, counters equal to what the entry points were handed, the profiler's
clock, and schedules and decisions bit-identical with recording on and
off."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.service as ts
from repro_torch import obs
from repro_torch.core.contention import tau_backend
from repro_torch.core.scenario import schedule_on
from repro_torch.service.store import MemoryStore, SqliteStore

# The parent of each span the scheduler's path opens (None: a root).
PARENTS = {
    "sched.policy": {None}, "sched.sweep": {"sched.policy"},
    "columnar.place": {"sched.sweep"}, "columnar.score": {"columnar.place"},
    "kernel.pick_orders": {"columnar.place"},
    "kernel.tau_stack": {"columnar.score", "daemon.chooser"},
    "tau_stack.h2d": {"kernel.tau_stack"},
    "tau_stack.launch": {"kernel.tau_stack"},
    "tau_stack.d2h": {"kernel.tau_stack"},
    "sim.simulate": {None, "daemon.monitor"},
    "daemon.round": {None}, "daemon.decide": {"daemon.round"},
    "daemon.chooser": {"daemon.decide"}, "daemon.monitor": {None},
    "journal.append": {None, "daemon.round", "daemon.decide",
                       "daemon.monitor"},
}


@pytest.fixture(autouse=True)
def _recorder_off():
    yield
    if obs.on:
        obs.stop()


def _backlog(n=24, servers=6):
    cluster = tc.philly_cluster(servers, seed=1)
    jobs = [dataclasses.replace(j, jid=i)
            for i, j in enumerate(tc.philly_workload(seed=3)[:n])]
    return cluster, jobs


def _schedule(engine, cluster, jobs):
    """One plan and its simulation on the kernels' plain versions."""
    request = tc.ScheduleRequest(
        cluster=cluster, jobs=jobs, horizon=1200,
        params={"placement": "columnar", "columnar_backend": "kernel",
                "engine": engine})
    with tau_backend("kernel", device="cpu"):
        schedule = schedule_on(request, "sjf-bco", "cpu")
    return schedule, tc.simulate(cluster, jobs, schedule.assignment)


def _drain(cluster, jobs, store=None):
    """The daemon over a stream, every decision priced through tau_stack."""
    with tau_backend("kernel", device="cpu"):
        svc = ts.SchedulerService(cluster, policy="sjf-bco",
                                  engine="batched", device="cpu",
                                  _store=store)
        for i, job in enumerate(jobs):
            svc.submit(ts.SubmitRequest(job, 2 * (i // 3)))
        return svc, svc.drain()


def _recorded(fn, *args):
    obs.start()
    out = fn(*args)
    return out, obs.stop()


def _entries(store):
    return [(e.seq, e.kind, e.jid, e.payload) for e in store.entries()]


def test_off_by_default_nothing_is_recorded():
    assert not obs.on
    obs.start()
    obs.stop()
    cluster, jobs = _backlog()
    _schedule("batched", cluster, jobs)
    _drain(cluster, jobs)
    rec = obs.stop()
    assert rec.spans == []
    assert set(rec.counters.values()) == {0}
    assert set(obs.COUNTERS.values()) == {0}


def test_recorder_nests_inherits_and_closes():
    obs.start()
    with obs.span("a"):
        with obs.span("b"):
            pass
        c = obs.open_span("c")
        obs.open_span("d")                 # left open, as by an exception
        obs.close_span(c)                  # closes its child too
    with obs.span("a"):
        pass
    with obs.span("open"):
        rec = obs.stop()
    assert [(n, p) for n, _, _, p in rec.spans] == [
        ("a", -1), ("b", 0), ("c", 0), ("d", 2), ("a", -1), ("open", -1)]
    assert rec.spans[3][2] == rec.spans[2][2]      # d closed with c
    assert rec.spans[-1][2] == rec.t_stop          # closed by stop()
    assert rec.calls() == {"a": 2, "b": 1, "c": 1, "d": 1, "open": 1}
    # A span open across start() leaves the new recording alone.
    with obs.span("x"):
        obs.start()
        with obs.span("y"):
            pass
    with obs.span("z"):
        pass
    rec = obs.stop()
    assert [(n, p) for n, _, _, p in rec.spans] == [("y", -1), ("z", -1)]


@pytest.mark.parametrize("engine", ["batched", "incremental"])
def test_children_lie_inside_their_parents(engine):
    cluster, jobs = _backlog()
    _, rec = _recorded(_schedule, engine, cluster, jobs)
    _, rec_d = _recorded(_drain, cluster, jobs)
    for r in (rec, rec_d):
        for name, t0, t1, p in r.spans:
            parent = r.spans[p][0] if p >= 0 else None
            assert parent in PARENTS[name], (name, parent)
            assert t0 <= t1
            if p >= 0:
                assert r.spans[p][1] <= t0 and t1 <= r.spans[p][2]
    names = {s[0] for s in rec.spans}
    assert {"sched.policy", "sched.sweep", "columnar.place", "columnar.score",
            "kernel.pick_orders", "sim.simulate"} <= names
    assert ("kernel.tau_stack" in names) == (engine == "batched")


def test_one_decide_span_per_job_each_with_one_chooser():
    cluster, jobs = _backlog(n=12)

    def three():
        for _ in range(3):
            _schedule("batched", cluster, jobs)

    _, rec = _recorded(three)
    assert rec.calls()["sched.policy"] == 3
    (svc, _), rec = _recorded(_drain, cluster, jobs)
    calls = rec.calls()
    assert calls["daemon.decide"] == calls["daemon.chooser"] == len(jobs)
    assert calls["daemon.round"] == svc.daemon.rounds
    for name, _, _, p in rec.spans:
        if name == "daemon.chooser":
            assert rec.spans[p][0] == "daemon.decide"


@pytest.mark.parametrize("engine", ["batched", "incremental"])
def test_self_times_under_a_root_sum_to_its_duration(engine):
    cluster, jobs = _backlog()
    _, rec = _recorded(_schedule, engine, cluster, jobs)
    _, rec_d = _recorded(_drain, cluster, jobs)
    for r in (rec, rec_d):
        own = r.self_ns()
        under = {}
        for i in range(len(r.spans)):
            root = i
            while r.spans[root][3] >= 0:
                root = r.spans[root][3]
            under[root] = under.get(root, 0) + own[i]
        assert under and all(v >= 0 for v in own)
        for root, total in under.items():
            assert total == r.spans[root][2] - r.spans[root][1]
        roots_s = sum(r.spans[i][2] - r.spans[i][1] for i in under) / 1e9
        assert sum(r.self_s().values()) == pytest.approx(roots_s, rel=1e-12)
        assert r.total_s()[r.spans[0][0]] >= r.self_s()[r.spans[0][0]]


@pytest.mark.parametrize("engine", ["batched", "incremental"])
def test_schedules_are_bit_identical_with_recording_on(engine):
    cluster, jobs = _backlog()
    off = _schedule(engine, cluster, jobs)
    on, rec = _recorded(_schedule, engine, cluster, jobs)
    assert rec.spans
    a, b = off[0], on[0]
    assert (a.theta, a.kappa, a.est_makespan, a.max_busy_time) == \
        (b.theta, b.kappa, b.est_makespan, b.max_busy_time)
    assert np.array_equal(a.est_start, b.est_start)
    assert np.array_equal(a.est_finish, b.est_finish)
    assert [(j, g.tolist()) for j, g in a.assignment] == \
        [(j, g.tolist()) for j, g in b.assignment]
    assert np.array_equal(off[1].finish, on[1].finish)
    assert (off[1].makespan, off[1].avg_jct) == (on[1].makespan,
                                                 on[1].avg_jct)


def test_decisions_are_bit_identical_with_recording_on():
    cluster, jobs = _backlog()
    svc_off, (s_off, sim_off) = _drain(cluster, jobs)
    (svc_on, (s_on, sim_on)), rec = _recorded(_drain, cluster, jobs)
    assert _entries(svc_off.daemon.store) == _entries(svc_on.daemon.store)
    assert np.array_equal(s_off.est_start, s_on.est_start)
    assert np.array_equal(sim_off.finish, sim_on.finish)
    # Each chooser span holds the interval decision_latencies times (on
    # the monotonic clock), and little more.
    chooser = [(b - a) / 1e9 for n, a, b, _ in rec.spans
               if n == "daemon.chooser"]
    lat = svc_on.daemon.decision_latencies
    assert len(chooser) == len(lat) == len(jobs)
    assert all(t - 1e-6 <= c < t + 1e-3 for c, t in zip(chooser, lat))
    assert len(svc_off.daemon.decision_latencies) == len(jobs)


@pytest.mark.parametrize("kind", ["backlog", "daemon"])
def test_row_counters_equal_what_the_entry_points_were_handed(
        kind, monkeypatch):
    from repro_torch.kernels import placement, tau
    tau_shapes, pool_rows = [], []
    tau_stack, pick_orders = tau.tau_stack, placement.pick_orders

    def tau_spy(cluster, G, share, compute, Y, device="cuda"):
        tau_shapes.append(Y.shape)
        return tau_stack(cluster, G, share, compute, Y, device=device)

    def pick_spy(cluster, U, *args, **kw):
        pool_rows.append(U.shape[0])
        return pick_orders(cluster, U, *args, **kw)

    monkeypatch.setattr(tau, "tau_stack", tau_spy)
    monkeypatch.setattr(placement, "pick_orders", pick_spy)
    cluster, jobs = _backlog()
    if kind == "backlog":
        _, rec = _recorded(_schedule, "batched", cluster, jobs)
    else:
        _, rec = _recorded(_drain, cluster, jobs)
    c = rec.counters
    assert tau_shapes
    assert c["tau.rows"] == sum(C * J for C, J, _ in tau_shapes)
    assert c["pool.rows"] == sum(pool_rows)
    assert (c["pool.rows"] > 0) == (kind == "backlog")
    calls = rec.calls()
    assert calls["kernel.tau_stack"] == len(tau_shapes)
    assert calls.get("kernel.pick_orders", 0) == len(pool_rows)
    if kind == "backlog":
        assert c["columnar.tries"] >= calls["columnar.place"] > 0
        assert calls["columnar.score"] <= c["columnar.tries"]


@pytest.mark.parametrize("store", ["memory", "sqlite"])
def test_journal_entries_count_every_append(store, tmp_path):
    cluster, jobs = _backlog(n=12)
    journal = MemoryStore() if store == "memory" \
        else SqliteStore(str(tmp_path / "journal.db"))
    obs.start()
    svc, _ = _drain(cluster, jobs, journal)
    rec = obs.stop()
    calls = rec.calls()
    assert calls["journal.append"] == len(journal) > 0
    assert calls["daemon.decide"] == len(jobs)
    assert calls["daemon.round"] == svc.daemon.rounds
    journal.close()


def test_a_span_holds_the_profiler_event_of_the_op_inside_it():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(256, 256, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        obs.start()
        with obs.span("op"):
            torch.mm(a, a)
        rec = obs.stop()
    (_, t0, t1, _), = rec.spans
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert len(events) == 1
    e = events[0]
    assert t0 <= e.start_ns() and e.start_ns() + e.duration_ns() <= t1


def test_tau_stack_spans_hold_their_three_children_in_order():
    cluster, jobs = _backlog()
    _, rec = _recorded(_drain, cluster, jobs)
    children = {}
    for i, (name, _, _, p) in enumerate(rec.spans):
        if p >= 0 and rec.spans[p][0] == "kernel.tau_stack":
            children.setdefault(p, []).append(name)
    tops = [i for i, s in enumerate(rec.spans) if s[0] == "kernel.tau_stack"]
    assert tops and sorted(children) == tops
    assert all(c == ["tau_stack.h2d", "tau_stack.launch", "tau_stack.d2h"]
               for c in children.values())


def test_regrows_count_the_doublings_of_a_recorded_sequence(monkeypatch):
    """The stacks a drain and a batched backlog hand tau_stack, reserved
    in turn on one staging: ``tau.regrows`` counts the calls that grew it
    (to the larger of the request and twice the buffer), and the others
    reuse its buffers."""
    from repro_torch.kernels import tau
    shapes, tau_stack = [], tau.tau_stack

    def tau_spy(cluster, G, share, compute, Y, device="cuda"):
        shapes.append((*Y.shape, G.ndim == 2))
        return tau_stack(cluster, G, share, compute, Y, device=device)

    monkeypatch.setattr(tau, "tau_stack", tau_spy)
    cluster, jobs = _backlog()
    _drain(cluster, jobs)
    _schedule("batched", cluster, jobs)
    monkeypatch.undo()
    assert len(shapes) > 10
    staging = tau._Staging(torch.device("cpu"))
    caps, grows, reused = [0, 0], 0, 0
    obs.start()
    for C, J, S, terms_2d in shapes:
        need = (tau.tau_words(C, J, S, terms_2d)[3], 3 * C * J)
        before = (staging.inp, staging.out)
        inp, out = staging.reserve(*need)
        grew = False
        for k in (0, 1):
            if need[k] > caps[k]:
                caps[k], grew = max(need[k], 2 * caps[k], 1), True
        grows += grew
        if not grew:
            reused += 1
            assert (inp, out) == before
        assert (inp[0].numel(), out[0].numel()) == tuple(caps)
    rec = obs.stop()
    assert rec.counters["tau.regrows"] == grows
    assert grows >= 2 and reused > grows
