"""The program's own spans and counters over a run's window, reduced to
per-layer numbers.

The program records spans and counters at its layer boundaries
(``repro_torch.obs``).  A traced run calls :func:`start` just before its
window and :func:`stop` just after it, hands ``stop()["intervals"]`` to
``devtrace.read`` beside its own spans (each idle gap then takes the
innermost span of either), and puts ``stop()``'s result in its record as
``program``.  :data:`METRICS` reads that record; :func:`summary` adds
how much of the window the program's root spans cover and how they agree
with the benchmark's own wrappers.  A program without the recorder reads
None throughout.
"""
from __future__ import annotations

#: The benchmark's spans around the program's calls (``drive.Spans``).
OUTER = ("schedule", "simulate", "submit", "drain", "outside any span")


def _obs():
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs


def start() -> bool:
    """Clear the program's recorder and turn it on; False where the
    program has none."""
    obs = _obs()
    if obs is None:
        return False
    obs.start()
    return True


def stop() -> "dict | None":
    """Turn the recorder off; what it recorded (``intervals`` as
    ``(name, t0 ns, t1 ns)``, ``total_s`` and ``self_s`` by span name,
    ``root_s``, the seconds of the spans with no parent by name, ``calls``,
    the spans of each name, and ``counters``), or None where it was not
    recording."""
    obs = _obs()
    if obs is None or not obs.on:
        return None
    rec = obs.stop()
    roots: dict[str, float] = {}
    for name, t0, t1, parent in rec.spans:
        if parent < 0:
            roots[name] = roots.get(name, 0.0) + (t1 - t0) / 1e9
    return {"intervals": rec.intervals(), "total_s": rec.total_s(),
            "self_s": rec.self_s(), "root_s": roots, "calls": rec.calls(),
            "counters": rec.counters}


# -- per-layer numbers of a record with ``program`` -------------------------

def _self_share(rec, kind, *names):
    p = rec.get("program")
    if p is None or rec["kind"] != kind:
        return None
    return 100.0 * sum(p["self_s"].get(n, 0.0) for n in names) \
        / rec["window_s"]


def _per(rec, kind, num, den):
    """``num`` over ``den``: each a counter, the spans of a name or a
    kernel's launches."""
    p = rec.get("program")
    if p is None or rec["kind"] != kind:
        return None

    def value(key):
        if key in p["counters"]:
            return p["counters"][key]
        return p["calls"].get(key, rec["launches"].get(key, 0))

    d = value(den)
    return value(num) / d if d else None


def _tau_copy_share(rec):
    p = rec.get("program")
    if p is None or "kernel.tau_stack" not in p["total_s"]:
        return None
    return 100.0 * (p["total_s"].get("tau_stack.h2d", 0.0)
                    + p["total_s"].get("tau_stack.d2h", 0.0)) \
        / rec["window_s"]


def _k1_rows(rec):
    p = rec.get("program")
    if p is None or not rec["launches"].get("tau"):
        return None
    return p["counters"]["tau.rows"] / rec["launches"]["tau"]


#: Each per-layer number by its name before the dot (``.sched`` backlog
#: cells, ``.service`` the daemon's): a function of the harness's record
#: with ``program`` (:func:`stop`) added, None where it has nothing to read.
METRICS = {
    "bisect_self_share": lambda r: _self_share(r, "backlog", "sched.policy",
                                               "sched.sweep"),
    "place_self_share": lambda r: _self_share(r, "backlog",
                                              "columnar.place"),
    "score_self_share": lambda r: _self_share(r, "backlog",
                                              "columnar.score"),
    "tries_per_step": lambda r: _per(r, "backlog", "columnar.tries",
                                     "columnar.place"),
    "pool_rows_per_launch": lambda r: _per(r, "backlog", "pool.rows",
                                           "pool"),
    "tau_copy_share": _tau_copy_share,
    "k1_rows_per_launch": _k1_rows,
    "chooser_self_share": lambda r: _self_share(r, "stream",
                                                "daemon.chooser"),
    "journal_entries_per_decision": lambda r: _per(
        r, "stream", "journal.append", "daemon.decide"),
}


def _rel(a: float, b: float) -> "float | None":
    return abs(a - b) / b if b else None


def summary(rec: dict, bench_spans: list, idle_gaps: list,
            wrapper: "dict | None" = None) -> dict:
    """The program part of a traced result: top self and total seconds,
    counters, the share of the window its root spans cover (the daemon's
    less the benchmark's ``submit`` spans of the window, ``bench_spans``),
    the idle seconds still labelled by the benchmark's outer spans, and
    the agreement of the program's spans with the benchmark's wrappers
    and shapes.  An entry point's agreement is ``[program s, wrapper s,
    relative gap, gap in us a call, the wrapper's own us a call (from
    ``wrapper``, measured by the caller), the relative gap left once
    that cost is taken off the wrapper's seconds]``."""
    p = rec["program"]
    window = rec["window_s"]
    top = sorted(p["self_s"].items(), key=lambda kv: -kv[1])
    out = {"self_s": dict(top[:16]), "total_s": p["total_s"],
           "root_s": p["root_s"], "calls": p["calls"],
           "counters": p["counters"]}
    if rec["kind"] == "backlog":
        covered = p["root_s"].get("sched.policy", 0.0) \
            + p["root_s"].get("sim.simulate", 0.0)
        out["closure"] = covered / window
    else:
        submit = sum(t1 - t0 for n, t0, t1 in bench_spans
                     if n == "submit") / 1e9
        covered = p["root_s"].get("daemon.round", 0.0) \
            + p["root_s"].get("daemon.monitor", 0.0)
        out["closure"] = covered / (window - submit)
    outer = sum(s for label, s in idle_gaps if label in OUTER)
    out["outer_idle_s"] = outer
    out["outer_idle_share"] = outer / window
    agree = {}
    for name in ("tau_stack", "pick_orders"):
        if rec["entry_s"].get(name):
            got, want = p["total_s"][f"kernel.{name}"], rec["entry_s"][name]
            calls = p["calls"][f"kernel.{name}"]
            own = (wrapper or {}).get(name)
            agree[name] = [got, want, _rel(got, want),
                           1e6 * (want - got) / calls, own,
                           None if own is None
                           else _rel(got, want - calls * own / 1e6)]
    if rec["kind"] == "backlog":
        got = p["total_s"].get("sim.simulate", 0.0)
        agree["simulate"] = [got, rec["simulate_s"],
                             _rel(got, rec["simulate_s"])]
    shapes = rec["shapes"]
    agree["tau_rows"] = [p["counters"]["tau.rows"],
                         sum(C * J for C, J, _, _ in shapes.get("tau", []))]
    agree["pool_rows"] = [p["counters"]["pool.rows"],
                          sum(nw for nw, _, _ in shapes.get("pool", []))]
    out["agreement"] = agree
    return out
