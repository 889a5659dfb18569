"""The import guard compares top-level names whole; the reference and the
generator import nothing of the program, of JAX or of its package; the
command refuses to run without a card or without the program."""
import json
import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness

ROOT = harness.ROOT


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []     # repro_torch is loaded
    monkeypatch.setitem(sys.modules, "reprox", types.ModuleType("reprox"))
    monkeypatch.setitem(sys.modules, "jax_like", types.ModuleType("j"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("r"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jl"))
    assert harness.forbidden_modules() == ["jaxlib", "repro"]


def test_the_yardstick_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference, portbench.gen, portbench.check, "
            "portbench.control, portbench.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax', 'torch'}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_a_cpu_run_loads_no_jax():
    import portbench.tests.test_portbench_faults as faults
    assert faults.run("daemon")["correct"]
    assert harness.forbidden_modules() == []


def _last_json(stdout: str):
    for line in reversed(stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", "s7-batched", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode != 0 and _last_json(p.stdout) is None


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "s7-batched", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path)
    assert p.returncode != 0 and _last_json(p.stdout) is None
