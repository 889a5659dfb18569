"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration and metric found by its name."""
import json
import re

import pytest

from portbench import gen, harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_cells_found_by_name(workload):
    entry, config, traffic = harness.cell(MAN, workload)
    assert entry["name"] == workload
    assert config["name"] == entry["config"]
    assert traffic["kind"] in ("backlog", "stream")
    e2e = harness.metrics_for(MAN, workload, trace=False)
    per_layer = harness.metrics_for(MAN, workload, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer
    for m in e2e + per_layer:
        assert callable(harness.reader(m["name"]))


def test_every_config_is_used_and_its_file_is_the_one_run():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert gen.load_json("configs", c["name"])["name"] == c["name"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        harness.cell(MAN, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        gen.load_json("traffic", "no-such-mix")
