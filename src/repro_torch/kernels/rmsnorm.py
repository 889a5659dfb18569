"""Fused RMSNorm: the CUDA kernel K7 and its plain version.

The port of ``repro/kernels/rmsnorm.py`` (TPU kernel ``_rmsnorm_kernel``)
and of its oracle ``repro/kernels/ref.py`` ``rmsnorm``: per row of
x [rows, d], ``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, returned in
x's dtype.  ``csrc/rmsnorm.cu`` reads each row once into the registers of
one warp, or of a few for a long row (see the note there).  The reference
tiles rows by ``block_rows`` and needs it to divide ``rows``; that is a
tiling detail of the TPU, so any ``rows`` and ``d`` work here.

:func:`rmsnorm` takes torch tensors: a CUDA tensor launches the kernel
(counted as ``"rmsnorm"``), a CPU tensor runs :func:`rmsnorm_plain`.  x
may have any row stride as long as its feature dim is contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build

__all__ = ["rmsnorm", "rmsnorm_plain"]

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {"rmsnorm_fwd": [_P] * 3 + [_L] * 2 + [_I] * 2 + [_D]
               + [_I] * 3 + [_P]}


def _check(x, scale) -> None:
    for name, t in (("x", x), ("scale", scale)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, d], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: dtype {x.dtype}, expected float32 or bfloat16")
    if not scale.is_floating_point():
        raise TypeError(f"scale: dtype {scale.dtype}, expected a float")
    if tuple(scale.shape) != (x.shape[1],):
        raise ValueError(f"scale: shape {tuple(scale.shape)}, expected "
                         f"({x.shape[1]},)")
    if scale.device != x.device:
        raise ValueError(f"scale: on {scale.device}, but x is on {x.device}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError("x: the feature dim must be contiguous")


def rmsnorm_plain(x, scale, eps: float = 1e-6):
    """Plain PyTorch version of K7, as ``repro.kernels.ref.rmsnorm``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    """K7 wrapper: RMSNorm of each row of x [rows, d] (float32 or
    bfloat16) with scale [d] (any float dtype: float32 and bfloat16 go to
    the kernel as they are and are widened there, others are cast to
    float32 first).  Returns a contiguous [rows, d] of x's dtype; fp32
    inside."""
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    _build.refuse_autograd("rmsnorm", x, scale)
    rows, d = x.shape
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows and d:
        if rows >= 2**31:
            raise ValueError(f"rows {rows} exceed the kernel's grid")
        if scale.dtype not in (torch.float32, torch.bfloat16):
            scale = scale.to(torch.float32)
        scale = scale.contiguous()
        # 16-byte loads and stores where every row starts on 16 bytes.
        per16 = 16 // x.element_size()
        vec = d % per16 == 0 and x.stride(0) % per16 == 0 \
            and x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0
        _build.launch("rmsnorm", _SIGNATURES, "rmsnorm_fwd", x.device,
                      x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                      x.stride(0), y.stride(0), rows, d, float(eps),
                      int(x.dtype == torch.bfloat16),
                      int(scale.dtype == torch.bfloat16), int(vec))
        LAUNCHES["rmsnorm"] += 1
    return y
