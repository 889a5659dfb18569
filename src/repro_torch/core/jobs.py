"""RAR-based DDL job model (paper §4.1) and the §7 Philly-trace workload.

Each job j requests ``G_j`` GPUs (its RAR ring width ``w_j = G_j``) and
``F_j`` training iterations.  Its per-iteration cost is governed by the
gradient size ``m_j`` (GB), mini-batch size ``M_j``, per-sample forward time
``dt_fwd`` (Delta_f) and fixed backward time ``dt_bwd`` (Delta_b).
``lam`` is the LBSGF server-spread tuning parameter lambda_j >= 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Job:
    jid: int
    num_gpus: int          # G_j == ring width w_j
    iters: int             # F_j, requested training iterations
    grad_size: float       # m_j, gradient bytes (GB) exchanged per iteration
    batch: int             # M_j, mini-batch size
    dt_fwd: float          # Delta_f, FP time per sample (slots)
    dt_bwd: float          # Delta_b, fixed BP time (slots)
    lam: float = 1.0       # lambda_j for LBSGF

    def __post_init__(self) -> None:
        if self.num_gpus < 1 or self.iters < 1:
            raise ValueError("job must request >=1 GPU and >=1 iteration")


# §7: 160 jobs scaled from the Microsoft Philly trace, by job-type share.
PHILLY_MIX: tuple[tuple[int, int], ...] = (
    (1, 80), (2, 14), (4, 26), (8, 30), (16, 8), (32, 2),
)


def philly_workload(
    seed: int = 0,
    mix: tuple[tuple[int, int], ...] = PHILLY_MIX,
    iters_range: tuple[int, int] = (1000, 6000),
    grad_range: tuple[float, float] = (0.5e-3, 2.0e-3),
    batch_range: tuple[int, int] = (16, 64),
    dt_fwd_per_sample: tuple[float, float] = (2.0e-4, 5.0e-4),
    dt_bwd_range: tuple[float, float] = (4.0e-3, 1.2e-2),
    lam: float = 1.0,
) -> list[Job]:
    """Generate the §7 workload (160 jobs by default).

    Constants are calibrated so that the contention-free per-iteration time
    tau_j lands in the paper's [0.01, 0.05] slots and the communication +
    overhead share is ~<=15% of the total at mild contention (§7.1).
    """
    rng = np.random.default_rng(seed)
    jobs: list[Job] = []
    jid = 0
    for gpus, count in mix:
        for _ in range(count):
            jobs.append(
                Job(
                    jid=jid,
                    num_gpus=gpus,
                    iters=int(rng.integers(*iters_range)),
                    grad_size=float(rng.uniform(*grad_range)),
                    batch=int(rng.integers(*batch_range)),
                    dt_fwd=float(rng.uniform(*dt_fwd_per_sample)),
                    dt_bwd=float(rng.uniform(*dt_bwd_range)),
                    lam=lam,
                )
            )
            jid += 1
    # Randomise arrival order within the batch (all arrive at t=0 in §7).
    order = rng.permutation(len(jobs))
    return [dataclasses.replace(jobs[i], jid=k) for k, i in enumerate(order)]


def jobs_field(jobs: list[Job], name: str) -> np.ndarray:
    """Vectorised accessor: np.array of a field across jobs."""
    return np.asarray([getattr(j, name) for j in jobs])
