"""The port's scheduling slice against the JAX reference, end to end.

The same Philly instance (carried across with
:func:`repro_torch.convert.from_reference`) is scheduled by the port's
policies on the columnar placement with its ``"kernel"`` backend on the
CPU (the kernels' plain versions) and must equal, bit for bit, the
reference's scalar/NumPy schedule and its columnar Pallas-kernel schedule
under x64.  Then ``run_scenario`` runs on both sides and the reports must
match field for field.  The port's structural rules are pinned here too:
no import of JAX or the reference, and no CPU fallback for ``"cuda"``.
"""
import ast
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.kernels.placement as ref_kp
import repro_torch
import repro_torch.core as tc
from repro_torch.convert import from_reference
from repro_torch.core.contention import tau_backend
from repro_torch.kernels import launch_counts

ROOT = pathlib.Path(__file__).resolve().parents[1]
HETERO = dict(speed_tiers=((50.0, 0.5), (12.5, 0.5)),
              link_classes=((1.25, "shared", 0.5), (1.25, "isolated", 0.5)))


def _case(hetero, seed=2):
    cluster = rc.philly_cluster(5, seed=seed, **(HETERO if hetero else {}))
    jobs = rc.philly_workload(seed=seed, mix=((1, 8), (2, 4), (4, 6),
                                              (8, 3), (16, 1)))
    return cluster, jobs


def _carry(cluster, jobs):
    return from_reference(cluster.to_payload(),
                          [dataclasses.asdict(j) for j in jobs])


def _assert_schedules_equal(a, b):
    assert (a.theta, a.kappa, a.est_makespan, a.max_busy_time) == \
        (b.theta, b.kappa, b.est_makespan, b.max_busy_time)
    assert len(a.assignment) == len(b.assignment)
    for (j1, g1), (j2, g2) in zip(a.assignment, b.assignment):
        assert j1 == j2 and np.array_equal(g1, g2)
    assert np.array_equal(a.est_start, b.est_start)
    assert np.array_equal(a.est_finish, b.est_finish)


class TestValueTypes:
    """Seeds give the same cluster and workload on both sides, and
    ``from_reference`` carries them across unchanged."""

    @pytest.mark.parametrize("seed", [0, 1, 7])
    @pytest.mark.parametrize("hetero", [False, True])
    def test_seeded_draws_match_reference(self, seed, hetero):
        kw = HETERO if hetero else {}
        ref_cluster = rc.philly_cluster(20, seed=seed, **kw)
        ref_jobs = rc.philly_workload(seed=seed)
        cluster = tc.philly_cluster(20, seed=seed, **kw)
        jobs = tc.philly_workload(seed=seed)
        assert cluster.to_payload() == ref_cluster.to_payload()
        assert [dataclasses.asdict(j) for j in jobs] == \
            [dataclasses.asdict(j) for j in ref_jobs]
        carried, carried_jobs = _carry(ref_cluster, ref_jobs)
        assert carried == cluster and carried_jobs == jobs
        assert np.array_equal(carried.server_speed_floor,
                              ref_cluster.server_speed_floor)


class TestPolicies:
    """sjf-bco / ff / ls x engines x cluster kinds."""

    @pytest.mark.parametrize("hetero", [False, True])
    @pytest.mark.parametrize("engine", ["incremental", "batched"])
    @pytest.mark.parametrize("policy", ["sjf-bco", "ff", "ls"])
    def test_port_kernel_backend_matches_reference(self, policy, engine,
                                                   hetero, monkeypatch):
        cluster, jobs = _case(hetero)
        want = rc.get_policy(policy)(rc.ScheduleRequest(
            cluster=cluster, jobs=jobs, horizon=2400,
            params={"engine": engine}))
        x64_was = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        monkeypatch.setattr(ref_kp, "DISPATCH_MIN_ROWS", 0)
        try:
            want_k = rc.get_policy(policy)(rc.ScheduleRequest(
                cluster=cluster, jobs=jobs, horizon=2400,
                params={"engine": engine, "placement": "columnar",
                        "columnar_backend": "kernel"}))
        finally:
            jax.config.update("jax_enable_x64", x64_was)
        p_cluster, p_jobs = _carry(cluster, jobs)
        with tau_backend("kernel", device="cpu"):
            got = tc.get_policy(policy)(tc.ScheduleRequest(
                cluster=p_cluster, jobs=p_jobs, horizon=2400,
                params={"engine": engine, "placement": "columnar",
                        "columnar_backend": "kernel", "device": "cpu"}))
        _assert_schedules_equal(want, got)
        _assert_schedules_equal(want_k, got)

    @pytest.mark.parametrize("policy", ["sjf-bco", "rand", "reserved",
                                        "sjf-bco-adaptive"])
    def test_default_params_match_reference(self, policy):
        cluster, jobs = _case(hetero=False, seed=4)
        want = rc.get_policy(policy)(rc.ScheduleRequest(
            cluster=cluster, jobs=jobs, horizon=2400))
        p_cluster, p_jobs = _carry(cluster, jobs)
        got = tc.get_policy(policy)(tc.ScheduleRequest(
            cluster=p_cluster, jobs=p_jobs, horizon=2400))
        _assert_schedules_equal(want, got)

    def test_registry(self):
        assert tc.list_policies() == rc.list_policies() == [
            "ff", "gadget-elastic", "ls", "rand", "reserved", "sjf-bco",
            "sjf-bco-adaptive", "sjf-bco-dynamic", "wang-ca"]
        assert tc.list_choosers() == rc.list_choosers()
        with pytest.raises(ValueError, match="columnar backend"):
            tc.get_policy("sjf-bco")(tc.ScheduleRequest(
                cluster=tc.philly_cluster(2, seed=0),
                jobs=tc.philly_workload(seed=0, mix=((1, 2),)),
                params={"placement": "columnar", "columnar_backend": "jit"}))


def _scenario(hetero, **kw):
    return dict(cluster=dict(num_servers=5, seed=3,
                             **(HETERO if hetero else {})),
                workload=dict(num_jobs=24, seed=3), **kw)


def _build(mod, spec):
    return mod.Scenario(cluster=mod.ClusterSpec(**spec["cluster"]),
                        workload=mod.WorkloadSpec(**spec["workload"]),
                        policy=spec.get("policy", "sjf-bco"),
                        policy_params=spec.get("policy_params", ()),
                        horizon=1200)


def _assert_reports_equal(a, b):
    _assert_schedules_equal(a.schedule, b.schedule)
    assert a.sim.makespan == b.sim.makespan
    assert a.sim.avg_jct == b.sim.avg_jct
    assert np.array_equal(a.sim.start, b.sim.start)
    assert np.array_equal(a.sim.finish, b.sim.finish)
    assert [dataclasses.astuple(e) for e in a.sim.events] == \
        [dataclasses.astuple(e) for e in b.sim.events]
    assert dataclasses.astuple(a.contention) == \
        dataclasses.astuple(b.contention)


class TestRunScenario:
    @pytest.mark.parametrize("hetero", [False, True])
    @pytest.mark.parametrize("policy", ["sjf-bco", "ls"])
    def test_report_matches_reference(self, policy, hetero):
        spec = _scenario(hetero, policy=policy)
        want = rc.run_scenario(_build(rc, spec))
        got = tc.run_scenario(_build(tc, spec), device="cpu")
        _assert_reports_equal(want, got)

    @pytest.mark.parametrize("hetero", [False, True])
    @pytest.mark.parametrize("engine", ["incremental", "batched"])
    def test_card_defaults_on_cpu_match_reference(self, engine, hetero):
        """What run_scenario sets on a CUDA device (columnar placement,
        kernel backends), run on the CPU's plain versions."""
        spec = _scenario(hetero, policy_params=(("engine", engine),))
        want = rc.run_scenario(_build(rc, spec))
        card = _scenario(hetero, policy_params=(
            ("engine", engine), ("placement", "columnar"),
            ("columnar_backend", "kernel")))
        before = launch_counts()
        with tau_backend("kernel", device="cpu"):
            got = tc.run_scenario(_build(tc, card), device="cpu")
        _assert_reports_equal(want, got)
        assert launch_counts() == before     # plain versions launch nothing

    def test_cuda_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tc.run_scenario(_build(tc, _scenario(False)), device="cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with tau_backend("kernel"):
                pass
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tc.get_policy("sjf-bco")(tc.ScheduleRequest(
                cluster=tc.philly_cluster(2, seed=0),
                jobs=tc.philly_workload(seed=0, mix=((1, 2),)),
                params={"placement": "columnar"}))

    def test_resolve_device(self):
        assert repro_torch.resolve_device("cpu") == torch.device("cpu")
        with pytest.raises(ValueError, match="unsupported device"):
            repro_torch.resolve_device("meta")
        with pytest.raises(ValueError, match="tau backend"):
            with tau_backend("jit"):
                pass


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"] + sorted((ROOT / "chip_probes").glob("*.py"))


class TestPortIsStandalone:
    @pytest.mark.parametrize("path", _port_sources(),
                             ids=lambda p: str(p.relative_to(ROOT)))
    def test_imports_neither_jax_nor_reference(self, path):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f"{path}: relative import"
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path}:{node.lineno} imports {name}"

    def test_chip_smoke_fails_without_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        alone = tmp_path / "chip_smoke.py"
        shutil.copy(ROOT / "chip_smoke.py", alone)
        for script, cwd in ((ROOT / "chip_smoke.py", ROOT),
                            (alone, tmp_path)):
            run = subprocess.run([sys.executable, str(script)], cwd=cwd,
                                 env=env, capture_output=True, text=True,
                                 timeout=120)
            assert run.returncode != 0
            assert '"ok": true' not in run.stdout
