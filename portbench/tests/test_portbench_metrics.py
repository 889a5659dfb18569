"""The readers of the end-to-end and per-layer metrics on records whose
answers are known by hand."""
import numpy as np
import pytest

from portbench import harness


def rec(**kw):
    base = {"kind": "stream", "setup_s": 7.5, "window_s": 10.0, "units": 4,
            "launches": {"pool": 400, "tau": 8}, "entry_s": {"a": 1.0,
                                                             "b": 0.5},
            "shapes": {}, "kernels": {}, "busy_s": 0.25,
            "trace_window_s": 10.0, "simulate_s": 0.5}
    base.update(kw)
    return base


def test_window_rate_counts_every_decision_over_the_whole_window():
    lat = [0.001] * 1500
    r = rec(latencies_s=lat, decisions=len(lat), chooser_s=[0.002] * 10,
            append_s=3.0)
    assert harness.reader("decisions_per_s")(r) == pytest.approx(150.0)
    assert harness.reader("journal_ms_per_decision.service")(r) == \
        pytest.approx(2.0)
    assert harness.reader("chooser_ms_p50.service")(r) == pytest.approx(2.0)


def test_p95_is_over_all_decisions():
    # 100 decisions at 1..100 ms: numpy's linear p95 is 95.05 ms.
    lat = [k / 1e3 for k in range(1, 101)]
    r = rec(latencies_s=lat, decisions=100)
    assert harness.reader("decision_ms_p95")(r) == pytest.approx(95.05)
    # Shuffled, the same.
    rng = np.random.default_rng(0)
    r["latencies_s"] = list(rng.permutation(lat))
    assert harness.reader("decision_ms_p95")(r) == pytest.approx(95.05)


def test_backlog_metrics():
    r = rec(kind="backlog")
    assert harness.reader("schedule_s")(r) == pytest.approx(2.5)
    assert harness.reader("decisions_per_s")(r) is None
    assert harness.reader("pool_launches.sched")(r) == pytest.approx(100.0)
    assert harness.reader("entry_host_share.sched")(r) == pytest.approx(15.0)
    assert harness.reader("simulate_share.sched")(r) == pytest.approx(5.0)
    assert harness.reader("policy_self_share.sched")(r) == \
        pytest.approx(80.0)
    assert harness.reader("idle_share.sched")(r) == pytest.approx(97.5)
    assert harness.reader("setup_s")(r) == 7.5


def test_silent_where_nothing_was_read():
    r = rec(kind="backlog", trace_window_s=None, busy_s=None)
    assert harness.reader("idle_share.sched")(r) is None
    assert harness.reader("k1_roofline.sched")(r) is None
    assert harness.reader("k3_roofline.sched")(r) is None


def test_a_reader_is_found_by_the_metric_s_base_name():
    r = rec(kind="backlog")
    for name in ("idle_share.sched", "idle_share.service"):
        assert harness.reader(name)(r) == pytest.approx(97.5)
    assert harness.reader("entry_host_share.service")(r) == \
        pytest.approx(15.0)
