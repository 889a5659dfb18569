"""Model-layout wrappers around the port's kernels.

The port of ``repro/kernels/ops.py``.  The reference repeats the kv heads
for grouped-query attention and pads the sequence to the Pallas block
size; the port's K5 kernel maps each query head to its kv head itself and
masks the ragged edge, so this wrapper only hands it transposed views
(no copies).  ``mlstm`` does the same for the K6 kernel, which the
reference's ``ops`` does not reach (its xLSTM model runs the jnp form).
``rmsnorm`` and ``swiglu`` take any leading shape and hand the K7 and K8
kernels 2-D views (no copies for contiguous input); the reference's
block-size halving for ragged row counts is a TPU tiling detail, since
the kernels mask their edges.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm as _ml
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import swiglu as _sg

__all__ = ["flash_attention", "mlstm", "rmsnorm", "swiglu"]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Model-layout entry point: q [B,S,H,hd], k/v [B,S,K,hd] (GQA ok).

    Returns [B,S,H,hd]: on a CUDA tensor through the K5 kernel, on a CPU
    tensor through its plain version."""
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              softcap=softcap, kv_len=k.shape[1])
    return out.transpose(1, 2)


def mlstm(q, k, v, F, i_pre):
    """Model-layout entry point of the mLSTM parallel form: q/k/v
    [B,S,H,hd] (v pre-scaled), F (cumulative log-forget) and i_pre
    [B,S,H] float32.

    Returns a contiguous [B,S,H,hd] of q's dtype: on a CUDA tensor through
    the K6 kernel, on a CPU tensor through its plain version."""
    y = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _ml.mlstm_parallel(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), F.transpose(1, 2),
                       i_pre.transpose(1, 2), out=y.transpose(1, 2))
    return y


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last dim of x [..., d] with scale [d].

    Returns x's shape and dtype: on a CUDA tensor through the K7 kernel, on
    a CPU tensor through its plain version."""
    return _rn.rmsnorm(x.reshape(-1, x.shape[-1]), scale, eps).reshape(
        x.shape)


def swiglu(x, w_gate, w_up):
    """``silu(x @ w_gate) * (x @ w_up)`` for x [..., K] and w [K, N].

    Returns [..., N] of x's dtype: on a CUDA tensor through the K8 kernel,
    on a CPU tensor through its plain version."""
    out = _sg.swiglu(x.reshape(-1, x.shape[-1]), w_gate, w_up)
    return out.reshape(*x.shape[:-1], w_gate.shape[-1])
