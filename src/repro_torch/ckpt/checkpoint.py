"""Flat-npz checkpointing for params + optimizer state.

The port of ``repro/ckpt/checkpoint.py``, file for file: one ``.npz``
whose keys are ``params/<path>``, ``opt/<path>`` and ``meta/step``, each
path the ``/``-joined dict keys and list indices of a leaf.  A file
written by either package loads in the other.  NumPy has no bfloat16:
the reference's ``np.savez`` writes its ``ml_dtypes`` bfloat16 leaves as
raw 2-byte records (dtype ``|V2``), and the port writes its bfloat16
leaves the same way and reads them back by viewing the bits.  ``load``
rebuilds the templates' structure, dtypes and devices.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten

__all__ = ["load", "save"]

_BF16_BITS = np.dtype("V2")


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(_BF16_BITS)
    return leaf.numpy()


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A tensor over ``arr`` (a fresh array read from the file)."""
    if arr.dtype == _BF16_BITS:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {"/".join(map(str, path)): _to_numpy(leaf)
            for path, leaf in flatten_with_paths(tree)}


def save(path: str, *, params: Any, opt_state: Any | None = None,
         step: int = 0) -> None:
    """Write params (and the optimizer state) with ``step`` to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"params/{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        payload.update({f"opt/{k}": v for k, v in _flatten(opt_state).items()})
    payload["meta/step"] = np.asarray(step)
    np.savez(path, **payload)


def load(path: str, *, params_like: Any, opt_like: Any | None = None
         ) -> tuple[Any, Any | None, int]:
    """Restore into the structure, dtypes and devices of the templates.
    Raises ``KeyError`` on a missing key and ``ValueError`` on a shape
    mismatch."""
    with np.load(path) as data:

        def restore(template: Any, prefix: str) -> Any:
            new_leaves = []
            for path_k, leaf in flatten_with_paths(template):
                key = prefix + "/".join(map(str, path_k))
                arr = data[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"{key}: shape {arr.shape} != {tuple(leaf.shape)}")
                new_leaves.append(_to_tensor(arr).to(dtype=leaf.dtype,
                                                      device=leaf.device))
            return unflatten(template, new_leaves)

        params = restore(params_like, "params/")
        opt = restore(opt_like, "opt/") if opt_like is not None else None
        return params, opt, int(data["meta/step"])
