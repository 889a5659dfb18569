"""The reading of the program's own spans and counters
(``portbench/program.py``, run through ``portbench/program_run.py``): its
numbers on records whose answers are known by hand, a traced run on the
CPU whose program spans agree with the benchmark's wrappers, and a
program without the recorder, which reads nothing and does not fail."""
import sys

import pytest

from portbench import gen, harness, program, program_run

CONFIG = gen.load_json("configs", "philly-s7")
CONFIG = dict(CONFIG, servers=dict(CONFIG["servers"], count=8),
              jobs=dict(CONFIG["jobs"], total=48))
#: The card's defaults for a backlog, so the CPU run goes through
#: pick_orders and tau_stack (their plain versions).
COLUMNAR = {"engine": "batched", "placement": "columnar",
            "columnar_backend": "kernel"}
TRAFFIC = {
    "s7-batched": {"kind": "backlog", "inputs": 2, "params": COLUMNAR},
    "s7-daemon-mem": {"kind": "stream", "inputs": 2,
                      "arrivals": {"process": "slot0"}},
}
COUNTERS = {"columnar.tries": 500, "pool.rows": 1200, "tau.rows": 30000}
CALLS = {"columnar.place": 400, "daemon.decide": 640,
         "journal.append": 3848}


def rec(kind, **program_kw):
    prog = {"self_s": {"sched.policy": 0.5, "sched.sweep": 0.25,
                       "columnar.place": 4.0, "columnar.score": 1.5,
                       "daemon.chooser": 2.0},
            "total_s": {"kernel.tau_stack": 3.0, "tau_stack.h2d": 1.0,
                        "tau_stack.d2h": 1.5},
            "root_s": {}, "calls": dict(CALLS), "counters": dict(COUNTERS)}
    prog.update(program_kw)
    return {"kind": kind, "window_s": 10.0, "launches": {"pool": 400,
                                                          "tau": 600},
            "program": prog}


@pytest.mark.parametrize("name,kind,want", [
    ("bisect_self_share", "backlog", 7.5),
    ("place_self_share", "backlog", 40.0),
    ("score_self_share", "backlog", 15.0),
    ("tries_per_step", "backlog", 1.25),
    ("pool_rows_per_launch", "backlog", 3.0),
    ("tau_copy_share", "backlog", 25.0),
    ("tau_copy_share", "stream", 25.0),
    ("k1_rows_per_launch", "backlog", 50.0),
    ("k1_rows_per_launch", "stream", 50.0),
    ("chooser_self_share", "stream", 20.0),
    ("journal_entries_per_decision", "stream", 6.0125),
])
def test_numbers_on_a_hand_made_record(name, kind, want):
    assert program.METRICS[name](rec(kind)) == pytest.approx(want)


BACKLOG = ("bisect_self_share", "place_self_share", "score_self_share",
           "tries_per_step", "pool_rows_per_launch")
STREAM = ("chooser_self_share", "journal_entries_per_decision")


@pytest.mark.parametrize("name", list(program.METRICS))
def test_silent_where_nothing_was_read(name):
    for kind in ("backlog", "stream"):
        r = rec(kind)
        r["program"] = None
        assert program.METRICS[name](r) is None
    if name in BACKLOG:
        assert program.METRICS[name](rec("stream")) is None
    if name in STREAM:
        assert program.METRICS[name](rec("backlog")) is None
    bare = rec("backlog", total_s={})
    bare["launches"] = {"pool": 0, "tau": 0}
    if name in ("tau_copy_share", "k1_rows_per_launch",
                "pool_rows_per_launch"):
        assert program.METRICS[name](bare) is None


def run(name, seconds=0.01):
    from repro_torch.core.contention import tau_backend
    man = harness.manifest()
    with tau_backend("kernel", device="cpu"):
        return program_run.run({"name": name, "chips": 1}, CONFIG,
                               TRAFFIC[name], 2**31 + 5, seconds, True,
                               harness.metrics_for(man, name, True),
                               device="cpu")


def test_program_spans_agree_with_the_benchmark_s_own():
    result = run("s7-batched")
    assert result["correct"]
    p = result["program"]
    agree = p["agreement"]
    # The benchmark's wrappers hold each entry point's span plus their own
    # microseconds a call, which a second wrapper measures in place: less
    # that, each agrees within 3%.
    for name in ("tau_stack", "pick_orders"):
        mine, theirs, _, gap_us, own_us, left = agree[name]
        assert mine <= theirs and 0 < own_us, name
        assert left <= 0.03, (name, gap_us, own_us)
    got, want, _ = agree["simulate"]
    assert got <= want <= 1.03 * got
    assert agree["tau_rows"][0] == agree["tau_rows"][1] > 0
    assert agree["pool_rows"][0] == agree["pool_rows"][1] > 0
    assert p["closure"] >= 0.95
    for name in ("bisect_self_share.sched", "place_self_share.sched",
                 "score_self_share.sched", "tries_per_step.sched",
                 "tau_copy_share.sched"):
        assert name in result["metrics"]
    # The device trace labels idle time with the program's spans now.
    assert {label for label, _ in result["breakdown"]["idle_gaps"]} \
        - set(program.OUTER)


def test_the_daemon_s_cell_reads_its_numbers():
    result = run("s7-daemon-mem")
    assert result["correct"]
    p = result["program"]
    assert p["calls"]["daemon.decide"] == 96
    # Building each 48-job service and its schedule lies outside the
    # rounds: a few per cent at this size.
    assert p["closure"] >= 0.9
    assert result["metrics"]["journal_entries_per_decision.service"][
        "value"] == pytest.approx((1 + 48 * 6 + 1) / 48)
    assert "chooser_self_share.service" in result["metrics"]


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    # The program's modules are loaded first and keep their recorder;
    # only the benchmark's lookup of it fails.
    import repro_torch
    import repro_torch.core
    import repro_torch.kernels.placement
    import repro_torch.service  # noqa: F401
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert program.start() is False and program.stop() is None
    result = run("s7-batched")
    assert result["correct"]
    assert "program" not in result
    assert not set(result["metrics"]) & {f"{n}.sched"
                                         for n in program.METRICS}
