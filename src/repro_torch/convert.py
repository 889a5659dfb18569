"""Carry a problem instance across from the reference's plain-data forms.

The scheduler has no weights; its counterpart of carrying weights across
is the cluster and the job list.  The reference emits both as plain data
-- ``Cluster.to_payload()`` (a dict of numbers, tuples and strings) and
``dataclasses.asdict(job)`` -- so the port rebuilds its own value types
from those without importing the reference.
"""
from __future__ import annotations

from repro_torch.core.cluster import Cluster
from repro_torch.core.jobs import Job

__all__ = ["from_reference"]


def from_reference(cluster_payload: dict, job_records: list[dict]
                   ) -> tuple[Cluster, list[Job]]:
    """The port's ``(Cluster, [Job])`` from a reference cluster payload and
    job records.  Every float is carried bit for bit, so both sides then
    hold the same instance."""
    cluster = Cluster.from_payload(cluster_payload)
    jobs = [Job(**dict(rec)) for rec in job_records]
    return cluster, jobs
