"""Inputs of every cell, made from ``--seed`` and the cell's data files.

One general generator reads a configuration (``configs/<config>.json``:
the cluster and the job population of a deployment) and a traffic mix
(``traffic/<traffic>.json``: how the jobs reach the scheduler) and makes
plain Python/NumPy inputs that both the program and the reference are
handed.  Nothing here imports the program.

The job parameters are drawn as the §7 Philly workload draws them (Yu et
al., MobiHoc '22, §7; the draw and ``mix_for`` are copies of the
program's ``philly_workload`` and ``chip_smoke.mix_for``), and the
cluster as ``philly_cluster`` draws it: each server's GPUs from
U{4,8,16,32}.  The servers, the jobs, their order and their arrival gaps
of input ``i`` are drawn once from the configuration's ``base_seed`` and
``i``; ``--seed`` draws the order of the servers, and so the GPU ids of
every placement.  Relabelled servers leave the scheduler the same work
(its ties fall between servers and GPUs that are alike), so runs with
different seeds measure the same thing, while each seed's schedules,
placements and journal differ and are checked anew.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Job:
    """One ring-all-reduce training job (paper §4.1): G GPUs, F iterations,
    gradient size m (GB), mini-batch M, per-sample forward and fixed
    backward times (slots), LBSGF spread lambda."""

    num_gpus: int
    iters: int
    grad_size: float
    batch: int
    dt_fwd: float
    dt_bwd: float
    lam: float = 1.0


@dataclasses.dataclass(frozen=True)
class Instance:
    """One input of a cell: the cluster's per-server GPU counts, the jobs
    (list index = job id) and their arrival slots (``None``: a backlog,
    every job at slot 0)."""

    capacities: tuple[int, ...]
    jobs: tuple[Job, ...]
    arrivals: "np.ndarray | None"


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def mix_for(mix: list, total: int) -> tuple[tuple[int, int], ...]:
    """The (G, count) mix scaled to ``total`` jobs, keeping the job-size
    shares; the remainder lands on the largest fractional parts."""
    base = sum(c for _, c in mix)
    exact = [(g, total * c / base) for g, c in mix]
    counts = [int(x) for _, x in exact]
    order = sorted(range(len(exact)), key=lambda i: exact[i][1] - counts[i],
                   reverse=True)
    for i in order[: total - sum(counts)]:
        counts[i] += 1
    return tuple((g, c) for (g, _), c in zip(exact, counts) if c > 0)


def draw_jobs(spec: dict, rng: np.random.Generator) -> list[Job]:
    """The Philly workload draw: per (G, count) of the mix, ``count`` jobs
    with iterations, gradient size, batch and step times drawn uniformly
    from the configured ranges, in the order ``philly_workload`` draws
    them."""
    mix = mix_for(spec["mix"], spec.get("total", sum(c for _, c in
                                                      spec["mix"])))
    jobs = []
    for gpus, count in mix:
        for _ in range(count):
            jobs.append(Job(
                num_gpus=int(gpus),
                iters=int(rng.integers(*spec["iters"])),
                grad_size=float(rng.uniform(*spec["grad_size"])),
                batch=int(rng.integers(*spec["batch"])),
                dt_fwd=float(rng.uniform(*spec["dt_fwd"])),
                dt_bwd=float(rng.uniform(*spec["dt_bwd"])),
                lam=float(spec.get("lam", 1.0))))
    return jobs


def capacities(spec: dict, rng: np.random.Generator) -> list[int]:
    """Per-server GPU counts: ``count`` servers, each drawn uniformly from
    ``sizes`` (``philly_cluster``'s draw)."""
    return [int(c) for c in rng.choice(spec["sizes"], size=spec["count"])]


def gaps(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """Inter-arrival gaps (slots) of ``n`` jobs: ``slot0`` puts every job
    at slot 0, as §7's backlog is."""
    if spec["process"] == "slot0":
        return np.zeros(n)
    raise ValueError(f"unknown arrival process {spec['process']!r}")


def instance(config: dict, traffic: dict, seed: int, index: int = 0
             ) -> Instance:
    """Input ``index`` of a cell for ``--seed``: its servers, jobs, their
    order and their arrivals from ``base_seed`` and ``index``, the order of
    its servers from ``seed`` (the same permutation for every input of a
    run)."""
    base = np.random.default_rng([int(config["base_seed"]), index])
    caps = capacities(config["servers"], base)
    caps = [caps[i] for i in np.random.default_rng(int(seed)).permutation(
        len(caps))]
    jobs = draw_jobs(config["jobs"], base)
    jobs = [jobs[i] for i in base.permutation(len(jobs))]
    arrivals = None
    spec = traffic.get("arrivals")
    if spec is not None:
        arrivals = np.floor(np.cumsum(gaps(spec, len(jobs), base))).astype(
            np.int64)
    return Instance(capacities=tuple(caps), jobs=tuple(jobs),
                    arrivals=arrivals)
