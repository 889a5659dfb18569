"""A run driven past the harness's look for a card, on the CPU at a small
size, with the timed path broken underneath: ``correct`` has to come out
false for each fault the cells can have, and true without one."""
import dataclasses

import numpy as np
import pytest

from portbench import gen, harness

CONFIG = gen.load_json("configs", "philly-s7")
CONFIG = dict(CONFIG, servers=dict(CONFIG["servers"], count=8),
              jobs=dict(CONFIG["jobs"], total=48))
TRAFFIC = {
    "backlog": {"kind": "backlog", "inputs": 2,
                "params": {"engine": "batched"}},
    "daemon": {"kind": "stream", "inputs": 2,
               "arrivals": {"process": "slot0"}},
}


def run(kind, seed=2**31 + 3):
    man = harness.manifest()
    name = {"backlog": "s7-batched", "daemon": "s7-daemon-mem"}[kind]
    return harness.run({"name": name, "chips": 1}, CONFIG, TRAFFIC[kind],
                       seed, 0.01, False, harness.metrics_for(man, name,
                                                              False),
                       device="cpu")


@pytest.mark.parametrize("kind", list(TRAFFIC))
def test_sound_run_is_correct(kind):
    result = run(kind)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("kind", list(TRAFFIC))
def test_an_answer_altered_where_it_is_produced(kind, monkeypatch):
    from repro_torch.core.api import PlacementState
    commit = PlacementState.commit

    def altered(self, job, gpus, rho, start, u):
        if job.jid == 0:
            gpus = (np.asarray(gpus) + 1) % self.cluster.num_gpus
        return commit(self, job, gpus, rho, start, u)

    monkeypatch.setattr(PlacementState, "commit", altered)
    result = run(kind)
    assert not result["correct"]
    assert result["checks"]["jobs_differing"]["value"] >= 1


@pytest.mark.parametrize("kind", list(TRAFFIC))
def test_a_step_that_leaves_the_state_unchanged(kind, monkeypatch):
    from repro_torch.core.api import PlacementState
    commit = PlacementState.commit

    def unchanged(self, job, gpus, rho, start, u):
        U, R = self.U.copy(), self.R.copy()
        commit(self, job, gpus, rho, start, u)
        self.U[:], self.R[:] = U, R

    monkeypatch.setattr(PlacementState, "commit", unchanged)
    assert not run(kind)["correct"]


def test_half_the_backlog_left_out(monkeypatch):
    from repro_torch.core import scenario
    schedule_on = scenario.schedule_on

    def half(*args, **kw):
        s = schedule_on(*args, **kw)
        return dataclasses.replace(s, assignment=s.assignment[::2])

    monkeypatch.setattr(scenario, "schedule_on", half)
    result = run("backlog")
    assert not result["correct"]
    assert result["checks"]["jobs_differing"]["value"] >= 24


def test_half_the_stream_left_out(monkeypatch):
    from repro_torch.service import api
    submit = api.SchedulerService.submit
    seen = []

    def half(self, request):
        seen.append(1)
        if len(seen) % 2:
            return submit(self, request)
        return api.JobHandle(jid=-1, tenant=request.tenant)

    monkeypatch.setattr(api.SchedulerService, "submit", half)
    result = run("daemon")
    assert not result["correct"]
    assert result["checks"]["undecided"]["value"] >= 24


def test_an_acknowledged_decision_missing_from_the_journal(monkeypatch):
    from repro_torch.service import store
    append = store.MemoryStore.append

    def lossy(self, kind, jid, payload, ts=0.0):
        if kind == "decided" and jid % 7 == 3:
            return store.JournalEntry(seq=-1, ts=ts, kind=kind, jid=jid,
                                      payload=payload)
        return append(self, kind, jid, payload, ts=ts)

    monkeypatch.setattr(store.MemoryStore, "append", lossy)
    result = run("daemon")
    assert not result["correct"]
    assert result["checks"]["journal_missing"]["value"] >= 1
