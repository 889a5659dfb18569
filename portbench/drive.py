"""The program's side of a run: its inputs, its entries, and what the
benchmark reads from it.

The window of a ``backlog`` cell drives what ``run_scenario`` runs once
its request is built: ``schedule_on`` (the plan) and ``simulate`` (its
execution), on the benchmark's inputs.  The window of a ``stream`` cell
drives ``SchedulerService.submit`` and ``drain``.  Everything of the
program is imported inside functions, so the reference and the tests of
the harness import this module without it.
"""
from __future__ import annotations

import contextlib
import time

ENTRY_POINTS = (("placement", "pick_orders"), ("placement", "score_probes"),
                ("tau", "tau_stack"))


class Spans:
    """Host spans (name, start ns, end ns) on the clock the profiler
    stamps its events with; recorded only while ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.items: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))


class Probe:
    """What the traced run reads from the program: host seconds inside
    each kernel entry point, and the shapes of each K1 and K3 launch."""

    def __init__(self):
        self.spent = {name: 0.0 for _, name in ENTRY_POINTS}
        self.shapes: dict[str, list[tuple]] = {"tau": [], "pool": []}


def wrap_entry_points(probe: Probe, spans: Spans):
    """Wrap ``pick_orders``, ``score_probes`` and ``tau_stack`` in place on
    their modules (their callers look them up there at call time): each
    call adds its host seconds, and ``pick_orders`` and ``tau_stack`` the
    shapes of the launch they make.  Returns a function that puts the
    originals back."""
    from repro_torch.kernels import placement, tau
    mods = {"placement": placement, "tau": tau}
    saved = []

    def shapes_of(name, args, out):
        if name == "pick_orders":
            cluster, U = args[0], args[1]
            if U.shape[0]:
                out["pool"].append((U.shape[0], U.shape[1],
                                    cluster.num_servers))
        elif name == "tau_stack":
            G, Y = args[1], args[4]
            C, J, S = Y.shape
            if C and J:
                out["tau"].append((C, J, S, G.ndim == 2))

    for mod_name, name in ENTRY_POINTS:
        mod = mods[mod_name]
        orig = getattr(mod, name)

        def timed(*args, _fn=orig, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                with spans.span(_name):
                    return _fn(*args, **kw)
            finally:
                probe.spent[_name] += time.perf_counter() - t0
                shapes_of(_name, args, probe.shapes)

        setattr(mod, name, timed)
        saved.append((mod, name, orig))

    def restore():
        for mod, name, orig in saved:
            setattr(mod, name, orig)

    return restore


def program_inputs(inst, config: dict):
    """The program's cluster (the configuration's contention constants) and
    jobs for an :class:`gen.Instance`."""
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.jobs import Job
    cluster = Cluster(capacities=inst.capacities, **config["cluster"])
    jobs = [Job(jid=i, num_gpus=j.num_gpus, iters=j.iters,
                grad_size=j.grad_size, batch=j.batch, dt_fwd=j.dt_fwd,
                dt_bwd=j.dt_bwd, lam=j.lam) for i, j in enumerate(inst.jobs)]
    return cluster, jobs


class Backlog:
    """One schedule of a backlog: ``schedule_on`` then ``simulate``."""

    def __init__(self, config: dict, traffic: dict, device):
        self.config, self.params, self.device = \
            config, dict(traffic.get("params", {})), device

    def unit(self, cluster, jobs, spans: Spans):
        from repro_torch.core.api import ScheduleRequest
        from repro_torch.core.scenario import schedule_on
        from repro_torch.core.simulator import simulate
        request = ScheduleRequest(cluster=cluster, jobs=jobs,
                                  horizon=int(self.config["horizon"]),
                                  u=float(self.config["u"]),
                                  params=dict(self.params))
        with spans.span("schedule"):
            schedule = schedule_on(request, self.config["policy"],
                                   self.device)
        with spans.span("simulate"):
            t0 = time.perf_counter()
            sim = simulate(cluster, jobs, schedule.assignment,
                           quotas=schedule.quotas)
            sim_s = time.perf_counter() - t0
        return schedule, sim, sim_s


class StampingStore:
    """The journal handed to the daemon: the program's own store, with the
    benchmark's clock on its boundary.  Records when each round starts
    (its ``advance`` entry is appended) and when each decision is
    acknowledged (its ``decided`` entry has been appended), and the host
    seconds spent appending."""

    def __init__(self, inner, spans: Spans):
        self.inner, self.spans = inner, spans
        self.round_start = None
        self.decided: list[tuple[int, float, float]] = []   # jid, t0, t1
        self.append_s = 0.0

    def append(self, kind, jid, payload, ts=0.0):
        t0 = time.perf_counter()
        if kind == "advance":
            self.round_start = t0
        with self.spans.span("journal_append"):
            entry = self.inner.append(kind, jid, payload, ts=ts)
        t1 = time.perf_counter()
        self.append_s += t1 - t0
        if kind == "decided":
            self.decided.append((jid, self.round_start, t1))
        return entry

    def entries(self):
        return self.inner.entries()

    def __len__(self):
        return len(self.inner)

    def close(self):
        self.inner.close()


class Stream:
    """One replay of a stream: a fresh ``SchedulerService`` over a fresh
    in-memory journal (the library's default), the whole stream
    submitted, then drained."""

    def __init__(self, config: dict, traffic: dict, device):
        self.config, self.device = config, device

    def unit(self, cluster, jobs, arrivals, spans: Spans):
        import repro_torch.service as svc
        from repro_torch.service.store import MemoryStore
        inner = MemoryStore()
        store = StampingStore(inner, spans)
        service = svc.SchedulerService(
            cluster, policy=self.config["policy"], device=self.device,
            horizon=int(self.config["horizon"]), u=float(self.config["u"]),
            _store=store)
        with spans.span("submit"):
            for job, arrival in zip(jobs, arrivals):
                service.submit(svc.SubmitRequest(job, int(arrival)))
        with spans.span("drain"):
            schedule, sim = service.drain()
        return {"store": store, "entries": inner.entries(),
                "chooser_s": list(service.daemon.decision_latencies),
                "schedule": schedule, "sim": sim, "n_jobs": len(jobs)}
