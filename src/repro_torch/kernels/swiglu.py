"""Fused SwiGLU gate: the CUDA kernel K8 and its plain version.

The port of ``repro/kernels/swiglu.py`` (TPU kernel ``_swiglu_kernel``)
and of its oracle ``repro/kernels/ref.py`` ``swiglu``:
``silu(x @ w_gate) * (x @ w_up)`` for x [M, K] and w [K, N], fp32
accumulators and an fp32 epilogue, returned in x's dtype.
``csrc/swiglu.cu`` computes both products itself, sharing the x tile
between them (see the note there): bfloat16 on the tensor cores
(``wgmma`` on 128 x 128 output tiles fed by TMA), float32 on the CUDA
cores.  The reference needs its blocks to divide M, N and K; here the
kernels mask the ragged edges, so any M, N and K work.

:func:`swiglu` takes torch tensors: a CUDA tensor launches the kernel
(counted as ``"swiglu"``), a CPU tensor runs :func:`swiglu_plain`.  Each
tensor may have any row stride as long as its last dim is contiguous, so
a column slice of a weight goes in as a view; a transposed weight is
refused.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, _build

__all__ = ["swiglu", "swiglu_plain"]

#: Rows of x the kernels take (the float32 kernel's grid: 65535 tiles of
#: 64 rows).
MAX_ROWS = 65535 * 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"swiglu_fwd": [_P] * 4 + [_L] * 4 + [_I] * 4 + [_P]}


def _check(x, w_gate, w_up) -> None:
    named = (("x", x), ("w_gate", w_gate), ("w_up", w_up))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: dtype {x.dtype}, expected float32 or bfloat16")
    for name, t in named[1:]:
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, but x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, but x is on {x.device}")
    if w_gate.shape != w_up.shape or w_gate.shape[0] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)} "
                         f"and w_up {tuple(w_up.shape)} do not fit [M, K] x "
                         "[K, N]")
    for name, t in named:
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous")


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where a TMA tensor map can read it (a 16-byte-aligned
    base, rows a multiple of 16 bytes, 8 bf16, apart and at least a row
    long), else a copy in a buffer whose rows are padded to a multiple of
    8 elements (the padding is never read: the maps end at the last real
    column)."""
    if (t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
            and t.stride(0) >= t.shape[1]):
        return t
    rows, cols = t.shape
    buf = torch.empty((rows, -(-cols // 8) * 8), dtype=t.dtype,
                      device=t.device)
    buf[:, :cols] = t
    return buf[:, :cols]


def swiglu_plain(x, w_gate, w_up):
    """Plain PyTorch version of K8, as ``repro.kernels.ref.swiglu``: both
    products in fp32 (full fp32 on the card unless TF32 is allowed),
    silu and the multiply in fp32, cast back to x's dtype."""
    x32 = x.float()
    g = x32 @ w_gate.float()
    u = x32 @ w_up.float()
    return (F.silu(g) * u).to(x.dtype)


def swiglu(x, w_gate, w_up):
    """K8 wrapper: ``silu(x @ w_gate) * (x @ w_up)`` for x [M, K] and
    w_gate/w_up [K, N], all float32 or all bfloat16.  Returns a contiguous
    [M, N] of x's dtype; fp32 inside.

    The bfloat16 kernel reads its operands by TMA, which needs a
    16-byte-aligned base and rows a multiple of 16 bytes apart: an operand
    that is not (an odd K or N, a column slice at an odd offset) goes in
    as an aligned, padded copy.  Contiguous weights of a width that is a
    multiple of 8, as a model's are, are read in place."""
    _check(x, w_gate, w_up)
    if x.device.type == "cpu":
        return swiglu_plain(x, w_gate, w_up)
    _build.refuse_autograd("swiglu", x, w_gate, w_up)
    M, K = x.shape
    N = w_gate.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M and N:
        if M > MAX_ROWS:
            raise ValueError(f"M = {M} exceeds the kernel's grid ({MAX_ROWS})")
        if x.dtype == torch.bfloat16:
            x, w_gate, w_up = (_tma_operand(t) for t in (x, w_gate, w_up))
        _build.launch("swiglu", _SIGNATURES, "swiglu_fwd", x.device,
                      x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                      out.data_ptr(), x.stride(0), w_gate.stride(0),
                      w_up.stride(0), out.stride(0), M, N, K,
                      int(x.dtype == torch.bfloat16))
        LAUNCHES["swiglu"] += 1
    return out
