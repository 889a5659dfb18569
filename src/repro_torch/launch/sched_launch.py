"""Scheduler-integrated multi-job launcher: SJF-BCO placing *real* RAR
training jobs onto GPU slices.

The port of ``repro/launch/sched_launch.py``: the same flags, policies,
job queue and architecture pool.  A multi-tenant cluster of ``--devices``
logical GPUs grouped into servers, a queue of RAR data-parallel training
jobs (reduced archs), SJF-BCO (or a baseline policy) deciding placement
and order with the scheduler's array work on ``--device``, and each job
then training with the explicit ring-all-reduce step on a ring of exactly
the logical GPU ids the scheduler assigned.  One card holds every ring, so
jobs run one after another, as the reference runs them on its CPU host:
wall-clock contention is not physical, and the simulator provides the
contention-aware makespan of the placement::

    PYTHONPATH=src python -m repro_torch.launch.sched_launch \
        --devices 8 --servers 2 --jobs 6 --policy sjf-bco --steps 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import Cluster, Job, ScheduleRequest, simulate
from repro_torch.core.scenario import schedule_on
from repro_torch.data import DataConfig, make_batch
from repro_torch.dist.steps import RingMesh, make_rar_train_step
from repro_torch.models import build_model
from repro_torch.models.config import InputShape
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig

ARCH_POOL = ["llama3.2-1b", "xlstm-350m", "internvl2-1b", "whisper-tiny",
             "hymba-1.5b", "deepseek-moe-16b"]


def job_queue(n_jobs: int, n_devices: int, seed: int
              ) -> tuple[list[Job], list[str]]:
    """The reference's job queue: reduced archs from the pool in turn,
    power-of-two ring widths, seeded iterations and compute times."""
    rng = np.random.default_rng(seed)
    jobs, job_archs = [], []
    for j in range(n_jobs):
        g = int(rng.choice([1, 2, min(4, n_devices)]))
        arch = ARCH_POOL[j % len(ARCH_POOL)]
        jobs.append(Job(jid=j, num_gpus=g,
                        iters=int(rng.integers(1000, 3000)),
                        grad_size=float(rng.uniform(5e-4, 2e-3)),
                        batch=32, dt_fwd=3e-4,
                        dt_bwd=float(rng.uniform(4e-3, 1.2e-2))))
        job_archs.append(arch)
    return jobs, job_archs


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns the ``schedule``, the simulated
    run ``sim`` and each job's ``losses``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--policy", default="sjf-bco",
                    choices=("sjf-bco", "ff", "ls", "rand", "reserved",
                             "sjf-bco-adaptive"))
    ap.add_argument("--steps", type=int, default=4,
                    help="real train steps per job (F_j for the simulator "
                         "is scaled from this)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.devices % args.servers:
        raise SystemExit("--devices must divide evenly into --servers")
    per_srv = args.devices // args.servers
    cluster = Cluster(capacities=(per_srv,) * args.servers)
    jobs, job_archs = job_queue(args.jobs, args.devices, args.seed)

    # --- schedule -----------------------------------------------------------
    sched = schedule_on(
        ScheduleRequest(cluster=cluster, jobs=jobs, horizon=100000),
        args.policy, dev)
    sim = simulate(cluster, jobs, sched.assignment)
    print(f"[sched] policy={args.policy}: simulated makespan "
          f"{sim.makespan:.0f} slots, avg JCT {sim.avg_jct:.0f}, "
          f"peak contention {sim.peak_contention}")

    # --- execute each job on its assigned GPU slice -------------------------
    shape = InputShape("sched", args.seq, 0, "train")
    losses = {}
    for j, gpu_ids in sched.assignment:
        arch = job_archs[j]
        cfg = get_config(arch).reduced()
        mesh = RingMesh(gpu_ids, dev)
        w = len(mesh.gpu_ids)
        model = build_model(cfg, max_seq=args.seq, device=dev)
        params = model.init(j)
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=args.steps)
        opt = adamw.init(ocfg, params)
        step_fn = make_rar_train_step(model, ocfg, mesh)
        batch_size = max(w, 2)
        t0 = time.time()
        losses[j] = []
        for step in range(args.steps):
            batch = make_batch(cfg, shape, step, DataConfig(seed=j),
                               batch_override=batch_size, device=dev)
            params, opt, metrics = step_fn(params, opt, batch)
            losses[j].append(float(metrics["loss"]))
        srvs = sorted({g // per_srv for g in mesh.gpu_ids})
        print(f"[sched] job {j:2d} ({arch:18s} w={w}) on devices "
              f"{list(mesh.gpu_ids)} (servers {srvs}): "
              f"loss {losses[j][0]:.3f}->{losses[j][-1]:.3f} in "
              f"{time.time()-t0:.1f}s "
              f"[start slot {sim.start[j]}, finish {sim.finish[j]}]")

    print(f"[sched] all {len(jobs)} jobs executed on their assigned slices")
    return {"schedule": sched, "sim": sim, "losses": losses}


if __name__ == "__main__":
    main()
