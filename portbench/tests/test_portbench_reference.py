"""The plain reference against the program's CPU path at a small size,
and its control, the reference in float32, read as not correct."""
import numpy as np
import pytest

from portbench import check, control, drive, gen, reference

CFG = gen.load_json("configs", "philly-s7")
DAEMON = {"kind": "stream", "inputs": 1,
          "arrivals": {"process": "slot0"}}


def small(config, count, total):
    config = dict(config, servers=dict(config["servers"], count=count),
                  jobs=dict(config["jobs"], total=total))
    return config


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_backlog_reference_equals_the_program_cpu_path(seed):
    from repro_torch.core.api import ScheduleRequest
    from repro_torch.core.scenario import schedule_on
    from repro_torch.core.simulator import simulate
    config = small(CFG, 8, 48)
    inst = gen.instance(config, {}, seed)
    cluster, jobs = drive.program_inputs(inst, config)
    got = schedule_on(ScheduleRequest(cluster, jobs, horizon=1200), "sjf-bco",
                      "cpu")
    sim = simulate(cluster, jobs, got.assignment)
    cl = reference.Cluster.make(inst.capacities, config["cluster"])
    want = reference.sjf_bco(cl, inst.jobs, 1200, 1.5)
    numbers = check.schedule_numbers(
        (got, sim), (want, reference.simulate(cl, inst.jobs,
                                              want.assignment)), 48)
    assert check.verdict(numbers)[0], numbers


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_stream_reference_equals_the_program_cpu_path(seed):
    config = small(CFG, 8, 64)
    inst = gen.instance(config, DAEMON, seed)
    cluster, jobs = drive.program_inputs(inst, config)
    unit = drive.Stream(config, DAEMON, "cpu").unit(
        cluster, jobs, inst.arrivals, drive.Spans(False))
    cl = reference.Cluster.make(inst.capacities, config["cluster"])
    want, outcomes = reference.online(cl, inst.jobs, inst.arrivals, 1200, 1.5)
    numbers = check.schedule_numbers(
        (unit["schedule"], unit["sim"]),
        (want, reference.simulate(cl, inst.jobs, want.assignment,
                                  inst.arrivals)), 64)
    numbers.update(check.decision_numbers(unit, outcomes))
    assert check.verdict(numbers)[0], numbers
    assert len(unit["store"].decided) == 64


def test_program_reads_the_configured_constants():
    config = dict(CFG, cluster=dict(CFG["cluster"], b_inter=2.5, xi1=0.5))
    cluster, _ = drive.program_inputs(gen.instance(config, {}, 1), config)
    assert (cluster.b_inter, cluster.xi1, cluster.alpha) == (2.5, 0.5, 0.3)


def test_the_reference_refuses_a_policy_it_does_not_implement():
    assert reference.policy("sjf-bco") == (reference.sjf_bco,
                                           reference.online)
    with pytest.raises(ValueError, match="sjf-bco-dynamic"):
        reference.policy("sjf-bco-dynamic")


def test_control_in_float32_is_not_correct():
    # One backlog at the cell's own size (a few seconds): at a much
    # smaller one the float32 clocks can happen to round alike.
    traffic = {"kind": "backlog", "inputs": 1}
    numbers = control.readings(CFG, traffic, 7)
    correct, checks = check.verdict(numbers)
    assert not correct and checks["busy_gap"]["value"] > 0
    correct, _ = check.verdict(control.readings(CFG, DAEMON, 7))
    assert not correct


def test_a_seed_relabels_the_servers_and_keeps_the_work():
    a = gen.instance(CFG, DAEMON, 1)
    b = gen.instance(CFG, DAEMON, 2**31 + 5)
    assert sorted(a.capacities) == sorted(b.capacities)
    assert a.capacities != b.capacities and a.jobs == b.jobs
    assert np.array_equal(a.arrivals, np.zeros(160))
    # Each input draws its own servers (U{4,8,16,32}) and jobs.
    c = gen.instance(CFG, DAEMON, 1, index=1)
    assert c.jobs != a.jobs and sorted(c.capacities) != sorted(a.capacities)
    assert len(a.capacities) == 20 and set(a.capacities) <= {4, 8, 16, 32}
    # The same schedule up to the GPU ids: same theta, kappa, makespan.
    x = [reference.sjf_bco(reference.Cluster.make(i.capacities,
                                                   CFG["cluster"]),
                           i.jobs, 1200, 1.5)
         for i in (gen.instance(small(CFG, 8, 48), {}, k) for k in (4, 5))]
    assert (x[0].theta, x[0].kappa, x[0].est_makespan) == \
        (x[1].theta, x[1].kappa, x[1].est_makespan)


def test_arrivals_and_mix():
    assert gen.gaps({"process": "slot0"}, 3, None).tolist() == [0, 0, 0]
    with pytest.raises(ValueError):
        gen.gaps({"process": "poisson"}, 3, None)
    assert gen.mix_for([[1, 80], [2, 14], [4, 26], [8, 30], [16, 8],
                        [32, 2]], 1024) == ((1, 512), (2, 90), (4, 166),
                                            (8, 192), (16, 51), (32, 13))
