"""mLSTM parallel form: the CUDA kernel K6 and its plain version.

The port of ``repro/kernels/mlstm.py`` (TPU kernel ``_mlstm_kernel``) and
of its oracle ``repro/kernels/ref.py`` ``mlstm_parallel``.  With F the
cumulative log-forget gate and i the input-gate pre-activations::

    D[t,s] = F_t - F_s + i_s              (s <= t)
    S[t,s] = (q_t . k_s) * exp(D[t,s] - m_t)      m_t = max_s D[t,s]
    y_t    = sum_s S[t,s] v_s / max(|sum_s S[t,s]|, exp(-m_t))

There is no 1/sqrt(hd) inside: the caller pre-scales one operand (the
xLSTM model scales v).  The layout is ``[BH, S, hd]`` for q/k/v and
``[BH, S]`` for F/i, as there, or ``[B, H, S, hd]`` and ``[B, H, S]``.
``csrc/mlstm.cu`` runs one CUDA block per (batch * head, query tile of 64
rows) and loops over kv tiles of 64 rows fed by ``cp.async`` through an
mbarrier ring; both products run as fp32 FMAs on the CUDA cores, q.k as
one chain over the head dim in its natural order, so that the scores
round as the plain version's do (see the note there for why not the
tensor cores).

:func:`mlstm_parallel` takes torch tensors: a CUDA tensor launches the
kernel (counted as ``"mlstm"``), a CPU tensor runs
:func:`mlstm_parallel_plain`, the full ``[..., S, S]`` fp32 form of the
reference oracle.  Each tensor may have any strides as long as the head
dim of q/k/v is contiguous, so the model layout ``[B, S, H, hd]`` goes in
as a transposed view (``repro_torch.kernels.ops.mlstm``).  S need not be a
multiple of any tile: the kernel masks the ragged edge.  The kernel reads
float32 rows that start on 16 bytes; :func:`_reads_in_place` decides which
operands it reads as they are, and the others go in as float32 copies.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build

__all__ = ["mlstm_parallel", "mlstm_parallel_plain", "HEAD_DIMS"]

#: Head dims the kernel is built for.
HEAD_DIMS = (32, 64, 128, 256, 512)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"mlstm_fwd": [_P] * 6 + [_L] * 18 + [_I] * 5 + [_P]}


def _reads_in_place(t: torch.Tensor) -> bool:
    """Whether the kernel reads q, k or v ``t`` ([B, H, S, hd]) as it is:
    float32 (a bfloat16 operand goes in as a float32 copy) with every row
    starting on 16 bytes, the kernel's ``cp.async`` copies -- a 16-byte
    aligned base and batch, head and sequence strides that are multiples
    of 4 elements (the stride of a dim of size 1 never moves a row)."""
    return t.dtype == torch.float32 and t.data_ptr() % 16 == 0 and all(
        s % 4 == 0 for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it, else a contiguous
    float32 copy in a fresh (aligned) allocation."""
    if _reads_in_place(t):
        return t
    return torch.empty(t.shape, dtype=torch.float32, device=t.device).copy_(t)


def _check(q, k, v, F, i_pre, out) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("F", F),
                    ("i_pre", i_pre), ("out", out)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, but q is on {q.device}")
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be [BH, S, hd] or [B, H, S, hd], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t is None:
            continue
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, but q is "
                             f"{q.dtype} {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    for name, t in (("F", F), ("i_pre", i_pre)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if t.shape != q.shape[:-1]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(q.shape[:-1])}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")


def mlstm_parallel_plain(q, k, v, F, i_pre, *, dtype=torch.float32):
    """Plain PyTorch version of K6: the full ``[..., S, S]`` decay and score
    matrices, as ``repro.kernels.ref.mlstm_parallel``, in ``dtype``
    arithmetic: float32, as the reference (the result then has q's dtype),
    or float64, a yardstick for both float32 versions (the result is
    float64)."""
    q32, k32, v32 = (t.to(dtype) for t in (q, k, v))
    F, i_pre = F.to(dtype), i_pre.to(dtype)
    S = q.shape[-2]
    D = F[..., :, None] - F[..., None, :] + i_pre[..., None, :]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    D = D.masked_fill(~causal, float("-inf"))
    m = D.amax(dim=-1, keepdim=True)
    w = torch.exp(D - m)
    scores = torch.einsum("...td,...sd->...ts", q32, k32) * w
    norm = torch.maximum(scores.sum(dim=-1, keepdim=True).abs(),
                         torch.exp(-m))
    y = torch.einsum("...ts,...sd->...td", scores / norm, v32)
    return y.to(q.dtype) if dtype == torch.float32 else y


def mlstm_parallel(q, k, v, F, i_pre, *, out=None):
    """K6 wrapper: the mLSTM parallel form of q/k/v ``[BH, S, hd]`` or
    ``[B, H, S, hd]`` (float32 or bfloat16, one dtype) with F and i_pre
    ``[BH, S]`` or ``[B, H, S]`` (float32).

    Returns y of q's shape and dtype, written into ``out`` when given (a
    tensor of that shape and dtype, head dim contiguous, any other strides)
    and else into a new tensor laid out like q.  fp32 inside: bfloat16
    q/k/v are read as float32 copies (exact), and float32 operands whose
    rows do not start on 16 bytes as aligned copies
    (:func:`_reads_in_place`)."""
    _check(q, k, v, F, i_pre, out)
    if q.device.type == "cpu":
        y = mlstm_parallel_plain(q, k, v, F, i_pre)
        return y if out is None else out.copy_(y)
    _build.refuse_autograd("mlstm", q, k, v, F, i_pre, out)
    if out is None:
        out = torch.empty_like(q)
    if q.dim() == 3:
        q4, k4, v4, o4 = (t.unsqueeze(1) for t in (q, k, v, out))
        F3, i3 = F.unsqueeze(1), i_pre.unsqueeze(1)
    else:
        q4, k4, v4, o4, F3, i3 = q, k, v, out, F, i_pre
    B, H, S, hd = q4.shape
    if B * H and S:
        q4, k4, v4 = (_kernel_operand(t) for t in (q4, k4, v4))
        strides = [s for t in (q4, k4, v4) for s in t.stride()[:3]] \
            + [s for t in (F3, i3) for s in t.stride()] \
            + list(o4.stride()[:3])
        _build.launch("mlstm", _SIGNATURES, "mlstm_fwd", q.device,
                      q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                      F3.data_ptr(), i3.data_ptr(), o4.data_ptr(), *strides,
                      B, H, S, hd, int(q.dtype == torch.bfloat16))
        LAUNCHES["mlstm"] += 1
    return out
