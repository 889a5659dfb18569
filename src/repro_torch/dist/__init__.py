"""Distributed RAR training substrate of the port (paper §3 made executable).

* :mod:`repro_torch.dist.rar`   -- the ring collectives on a worker axis
  (the Share-Reduce / Share-Only phases of Fig. 1) + the §3
  exchange-volume formula;
* :mod:`repro_torch.dist.sharding` -- mesh/placement rules for the
  production dry-run (params/batch/cache specs as DTensor placements,
  consumed by ``launch/dryrun.py``);
* :mod:`repro_torch.dist.steps` -- train/serve step factories, including
  the explicit RAR data-parallel step the scheduler launcher executes on
  each placement.
"""
from repro_torch.dist.rar import (exchange_bytes_per_worker, ring_all_gather,
                                  ring_all_reduce, ring_reduce_scatter)
from repro_torch.dist.steps import (RingMesh, make_rar_train_step,
                                    make_serve_step, make_train_step)

__all__ = [
    "RingMesh",
    "exchange_bytes_per_worker",
    "ring_all_gather",
    "ring_all_reduce",
    "ring_reduce_scatter",
    "make_rar_train_step",
    "make_serve_step",
    "make_train_step",
]
