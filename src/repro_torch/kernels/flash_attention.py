"""Blockwise online-softmax attention: the CUDA kernel K5 and its plain version.

The port of ``repro/kernels/flash_attention.py`` (TPU kernel
``_flash_kernel``) and of its oracle ``repro/kernels/ref.py``
``flash_attention``.  Layout ``[B, H, S, hd]`` as there; the kv tensors may
carry fewer heads ``K`` (``K`` divides ``H``, query head ``h`` reads kv
head ``h // (H // K)``), so grouped-query attention needs no repeated copy.
``csrc/flash_attention.cu`` runs one CUDA block per (batch * head, query
tile) and loops over kv tiles (see the note there): bfloat16 on the tensor
cores, float32 on the CUDA cores.

:func:`flash_attention` takes torch tensors: a CUDA tensor launches the
kernel (counted as ``"flash_attention"``), a CPU tensor runs
:func:`flash_attention_plain`, the full fp32 softmax of the reference
oracle plus the ``kv_len`` mask.  Each tensor may have any strides as long
as its head dim is contiguous, so the model layout ``[B, S, H, hd]`` goes
in as a transposed view; the output is laid out like ``q``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import LAUNCHES, _build

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS", "tiles"]

#: Head dims the kernel is built for.
HEAD_DIMS = (32, 64, 128, 256)

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {
    "flash_attention_fwd": [_P] * 4 + [_L] * 12 + [_I] * 9 + [_D, _D, _I, _P],
    "flash_attention_tiles": [_I, _I, _P, _P],
}


def tiles(hd: int, dtype: torch.dtype) -> tuple[int, int]:
    """(query rows per block, kv rows per tile) of the kernel that runs
    head dim ``hd`` in ``dtype``, as built (on the machine with the card)."""
    bq, bk = ctypes.c_int(), ctypes.c_int()
    lib = _build.load("flash_attention", _SIGNATURES)
    if lib.flash_attention_tiles(hd, int(dtype == torch.bfloat16),
                                 ctypes.byref(bq), ctypes.byref(bk)):
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    return bq.value, bk.value


def _rows_aligned(t) -> bool:
    """Every [.., .., s, :] row of t starts on 16 bytes (the bf16 kernel's
    cp.async copies): a 16-byte-aligned base and strides of 8 elements."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, heads, S, hd], got "
                             f"{tuple(t.shape)}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32 or "
                            "bfloat16")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, but q is "
                             f"{q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    B, H, _, hd = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"kv heads {k.shape[1]} must divide q heads {H}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, kv_len: int = 0):
    """Plain PyTorch version of K5: full fp32 scores and softmax.

    As ``repro.kernels.ref.flash_attention``, plus the kernel's ``kv_len``
    mask and its guard ``max(l, 1e-30)``, so that a fully masked row gives
    0 (the reference oracle has no such row)."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    kv_len = min(kv_len or Skv, Skv)
    q32, k32, v32 = q.float(), k.float(), v.float()
    if K != H:
        k32 = k32.repeat_interleave(H // K, dim=1)
        v32 = v32.repeat_interleave(H // K, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    q_idx = torch.arange(Sq, device=q.device)[:, None]
    k_idx = torch.arange(Skv, device=q.device)[None, :]
    mask = k_idx < kv_len
    if causal:
        rel = q_idx - k_idx
        mask = mask & (rel >= 0)
        if window:
            mask = mask & (rel < window)
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v32).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, kv_len: int = 0):
    """K5 wrapper: attention of q [B, H, Sq, hd] over k/v [B, K, Skv, hd].

    ``causal`` masks ``k_idx > q_idx`` (positions count from 0 on both
    axes), ``window > 0`` (causal only) also masks ``q_idx - k_idx >=
    window``, ``softcap`` applies ``softcap * tanh(s / softcap)`` to the
    scaled scores, and ``kv_len`` (0 = all) is the number of real kv
    positions.  float32 or bfloat16 in, the same out, fp32 scores and
    softmax inside.  The bfloat16 kernel copies its tiles with 16-byte
    asynchronous copies, so it needs every row of q, k and v to start on
    16 bytes; an operand whose rows do not goes in as a contiguous copy."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, kv_len=kv_len)
    _build.refuse_autograd("flash_attention", q, k, v)
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)          # same strides as q (dense layouts)
    if q.dtype == torch.bfloat16:
        q, k, v = (t if _rows_aligned(t)
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    if B * H and Sq:
        strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
        _build.launch("flash_attention", _SIGNATURES, "flash_attention_fwd",
                      q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), *strides, B, H, K, Sq, Skv, hd,
                      min(kv_len or Skv, Skv), int(causal), int(window),
                      math.sqrt(hd), float(softcap),
                      int(q.dtype == torch.bfloat16))
        LAUNCHES["flash_attention"] += 1
    return o
