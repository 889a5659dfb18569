"""Carry inputs and weights across from the reference's plain-data forms.

The scheduler has no weights; its counterpart of carrying weights across
is the cluster and the job list.  The reference emits both as plain data
-- ``Cluster.to_payload()`` (a dict of numbers, tuples and strings) and
``dataclasses.asdict(job)`` -- so the port rebuilds its own value types
from those without importing the reference.  Model weights come across
as nested dicts of NumPy arrays (``params_from_reference``), and the
AdamW state with them (``opt_from_reference``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cluster import Cluster
from repro_torch.core.jobs import Job
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.tree import flatten_with_paths, unflatten

__all__ = ["from_reference", "opt_from_reference", "params_from_reference"]


def from_reference(cluster_payload: dict, job_records: list[dict]
                   ) -> tuple[Cluster, list[Job]]:
    """The port's ``(Cluster, [Job])`` from a reference cluster payload and
    job records.  Every float is carried bit for bit, so both sides then
    hold the same instance."""
    cluster = Cluster.from_payload(cluster_payload)
    jobs = [Job(**dict(rec)) for rec in job_records]
    return cluster, jobs


def params_from_reference(tree: dict, cfg: ModelConfig, device="cuda"
                          ) -> dict:
    """The port's params from the reference's params pytree as nested dicts
    of NumPy arrays (``jax.tree.map(np.asarray, params)``), on ``device``.

    Both packages use the same names and stacked layouts -- ``[L, ...]``
    leaves under ``"layers"`` (dense), ``[G, n_m, ...]`` under ``"mlstm"``
    and ``[G, ...]`` under ``"slstm"`` (xlstm) -- so every leaf maps to the
    port's leaf of the same path, whatever the depth of the dicts.  A
    float32 leaf stays float32 (with a narrower ``cfg.param_dtype`` these
    are the leaves the reference pins to float32, such as xLSTM's ``w_if``
    and ``if_bias``); any other float leaf comes in ``cfg.param_dtype``.
    float32 values carry bit for bit (bfloat16 ones through float32,
    exactly)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)

    def carry(node, path):
        if isinstance(node, dict):
            return {k: carry(v, f"{path}/{k}") for k, v in node.items()}
        a = np.asarray(node)
        if a.dtype.kind not in "fV":
            raise TypeError(f"params{path}: dtype {a.dtype} is not a float")
        to = torch.float32 if a.dtype == np.float32 else dtype
        return torch.tensor(a.astype(np.float32), device=dev).to(to)

    return carry(tree, "")


def _exact_tensor(a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor of the same dtype and bits: float32 and int32 as
    they are, an ``ml_dtypes`` bfloat16 array through its 16-bit pattern."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def opt_from_reference(state: dict, params: dict, device="cuda") -> dict:
    """The port's AdamW state from the reference's (``jax.tree.map(
    np.asarray, opt)``: ``m``, ``v`` and ``step``), bit for bit and in the
    reference's dtypes (float32 or bfloat16 moments, int32 step), on
    ``device``, with the structure of the port's ``params``.  Raises on a
    missing leaf or a moment whose shape is not its param's."""
    dev = resolve_device(device)

    def carry(tree, name):
        out = []
        for path, p in flatten_with_paths(params):
            node = tree
            for k in path:
                node = node[k]
            a = np.asarray(node)
            if a.shape != tuple(p.shape):
                raise ValueError(f"opt/{name}/{'/'.join(map(str, path))}: "
                                 f"shape {a.shape} != {tuple(p.shape)}")
            out.append(_exact_tensor(a, dev))
        return unflatten(params, out)

    return {"m": carry(state["m"], "m"), "v": carry(state["v"], "v"),
            "step": _exact_tensor(np.asarray(state["step"]), dev)}
