"""Hand-written CUDA kernels of the port, for Hopper (sm_90a).

Each kernel sits behind a wrapper that checks its tensors (device,
dtype, shape, layout) and then either launches the
kernel (CUDA tensors) or runs the plain PyTorch version that sits beside
it in the same module (CPU tensors).  There is no fallback: a CUDA tensor
whose kernel fails to build or launch raises.  No kernel has a backward,
so a CUDA call that autograd would record raises too
(``_build.refuse_autograd``); the plain versions stay differentiable.

  * :mod:`repro_torch.kernels.tau` -- ``tau`` / ``tau_het``: the Eq. (6)-(8)
    candidate-stack reduction behind ``contention.stack_model``;
  * :mod:`repro_torch.kernels.placement` -- ``pool`` / ``score``: the
    columnar placement step's pool statistics and probe scoring;
  * :mod:`repro_torch.kernels.flash_attention` -- ``flash_attention``:
    blockwise online-softmax attention, the models' prefill attention
    (model layout through :mod:`repro_torch.kernels.ops`);
  * :mod:`repro_torch.kernels.mlstm` -- ``mlstm_parallel``: the xLSTM
    mLSTM parallel form, the xlstm models' prefill (model layout through
    :mod:`repro_torch.kernels.ops`);
  * :mod:`repro_torch.kernels.rmsnorm` -- ``rmsnorm``: fused RMSNorm of
    each row;
  * :mod:`repro_torch.kernels.swiglu` -- ``swiglu``: the fused SwiGLU gate
    ``silu(x @ w_gate) * (x @ w_up)`` as one dual product.  These two sit
    behind ``ops.rmsnorm`` / ``ops.swiglu`` (any leading shape), the
    reference's public entry points; as there, no model calls them.

:data:`LAUNCHES` counts kernel launches per kernel (a wrapper adds one
where it launches, and nowhere else), so a run can show that it went
through the kernels.
"""
from __future__ import annotations

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts"]

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES = {"tau": 0, "tau_het": 0, "pool": 0, "score": 0,
            "flash_attention": 0, "mlstm": 0, "rmsnorm": 0, "swiglu": 0}


def launch_counts() -> dict[str, int]:
    """Snapshot of the per-kernel launch counters."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    """Zero every kernel launch counter."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0
