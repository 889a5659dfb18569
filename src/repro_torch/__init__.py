"""PyTorch/CUDA port of the contention-aware ring-all-reduce scheduler.

A second package beside the JAX reference ``repro``: the same modules
under the same names (``repro_torch.core``, ``repro_torch.kernels``),
with host control in NumPy and the scheduler's array kernels written by
hand in CUDA C++ for Hopper (``sm_90a``).  Every engine and backend is
bit-identical in float64 to the reference's scalar walk.

Entry points take a ``device``: they run on the card unless the caller
asks for the CPU, where each kernel wrapper runs its plain PyTorch
version instead.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda", *, meta: bool = False) -> torch.device:
    """``device`` as a :class:`torch.device`.

    Raises when a CUDA device is asked for and ``torch.cuda.is_available()``
    is False: there is no silent CPU fallback.  With ``meta=True`` the
    ``meta`` device (shapes only, no storage) is accepted too: a model's
    param tree can be built there without allocating it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu") + (("meta",) if meta else ()):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
