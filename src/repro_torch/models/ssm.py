"""State-space and recurrent sequence mixers on torch tensors: the Mamba
head (Hymba) and the xLSTM cells (mLSTM / sLSTM).

The port of ``repro/models/ssm.py``, function for function:

  * Mamba's selective-SSM recurrence h_t = a_t * h_{t-1} + b_t runs over
    the sequence with :func:`associative_scan`, the odd/even recursion of
    ``jax.lax.associative_scan`` (log depth, O(S) work, the reference's
    association order), for train/prefill, and as a one-step recurrence
    for decode.
  * The mLSTM's parallel form (train/prefill) is attention-style with an
    additive log-decay matrix.  With ``cfg.use_flash_kernel`` it goes
    through the K6 kernel (``repro_torch.kernels.ops.mlstm``, its plain
    version on CPU tensors); otherwise through the reference's
    query-chunked block, whose [c, S] decay slab never grows to [S, S].
  * Decode uses the O(1) matrix-memory recurrence (C, n, m).
  * sLSTM is sequential: the reference's scan over time is a Python loop
    over the sequence here, one cell step per position; on the dry-run's
    fake tensors one op stands for the loop (``models/slstm_scan.py``).

The reference's dtypes are kept: q/k/v enter the parallel form in fp32,
the gate weights ``w_if``/``if_bias`` and every recurrent state are fp32,
and Mamba's ``dt_bias``/``A_log`` are fp32.  Where JAX promotes a
compute-dtype activation against a float32 weight, the port casts the
activation up (``torch.einsum`` refuses mixed dtypes).  The mLSTM's query
chunks carry the reference's ``shard_hint`` (the identity off a mesh); on
DTensors the mLSTM's parallel form and the sLSTM's loop run on each
shard's local tensors (:func:`_mlstm_sharded`, :func:`slstm_seq`).
"""
from __future__ import annotations

import functools
import math
import os

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (BATCH_AXES, _hint_placements,
                                       init_normal, init_uniform, rms_norm,
                                       shard_hint, zero_pad)
from repro_torch.models.slstm_scan import slstm_scan

# ---------------------------------------------------------------------------
# associative scan
# ---------------------------------------------------------------------------


def _take(t: torch.Tensor, dim: int, start: int, stop=None, step: int = 1):
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim`` (a one longer or equal)."""
    m = b.shape[dim]
    pairs = torch.stack([_take(a, dim, 0, m), b], dim=dim + 1
                        ).flatten(dim, dim + 1)
    return pairs if a.shape[dim] == m else torch.cat(
        [pairs, _take(a, dim, m)], dim=dim)


def associative_scan(fn, elems, dim: int = 0) -> list:
    """Inclusive scan of the tensors ``elems`` along ``dim`` with the
    associative ``fn(left, right) -> combined`` (each a sequence of
    tensors): element t of the result is fn applied over elements 0..t.

    The recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan the half-size result (the odd elements), then combine each odd
    result with the next even element.  Log depth, O(S) work, and the same
    association order as the reference."""
    elems = list(elems)
    dim = dim % elems[0].dim()
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn([_take(e, dim, 0, -1, 2) for e in elems],
                 [_take(e, dim, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    evens_in = [_take(e, dim, 2, None, 2) for e in elems]
    if n % 2 == 0:
        even = fn([_take(e, dim, 0, -1) for e in odd], evens_in)
    else:
        even = fn(odd, evens_in)
    even = [torch.cat([_take(e, dim, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


# ---------------------------------------------------------------------------
# Mamba-style selective SSM head (Hymba's parallel-to-attention branch)
# ---------------------------------------------------------------------------

_CONV_K = 4  # depthwise causal conv width


def init_mamba(gen, cfg: ModelConfig, dtype, lead: tuple = ()):
    """Every leaf with leading dims ``lead``; ``dt_bias`` and ``A_log``
    float32 whatever ``dtype`` is."""
    d = cfg.d_model
    Hs, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    inner = Hs * P
    dev = gen.device
    return {
        "w_in": init_normal(gen, lead + (d, 2 * inner), 1.0 / math.sqrt(d),
                            dtype),
        "w_conv": init_normal(gen, lead + (_CONV_K, inner), 0.2, dtype),
        "w_B": init_normal(gen, lead + (Hs, P, N), P ** -0.5, dtype),
        "w_C": init_normal(gen, lead + (Hs, P, N), P ** -0.5, dtype),
        "w_dt": init_normal(gen, lead + (Hs, P), P ** -0.5, dtype),
        "dt_bias": torch.zeros(lead + (Hs,), dtype=torch.float32,
                               device=dev),
        "A_log": init_uniform(gen, lead + (Hs, P, N), torch.float32),
        "D": torch.ones(lead + (Hs, P), dtype=dtype, device=dev),
        "w_out": init_normal(gen, lead + (inner, d), 1.0 / math.sqrt(inner),
                             dtype),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` step by step, x * (1 / (1 + exp(-x))), each step
    rounded to x's dtype as the reference's lowering rounds it: in bf16
    the Mamba head then matches the reference's bits (``F.silu`` rounds
    once, and its error and the reference's add up); in float32 the two
    agree to rounding."""
    return x * (1 / (1 + torch.exp(-x)))


def _promoted(u: torch.Tensor, w: torch.Tensor) -> tuple:
    """u and w in their common dtype, as JAX promotes them."""
    dt = torch.promote_types(u.dtype, w.dtype)
    return u.to(dt), w.to(dt)


def _mamba_gates(cfg, p, u):
    """Shared discretisation math.  u: [..., Hs, P] -> a, b coefficients
    (float32)."""
    dt = F.softplus(
        torch.einsum("...hp,hp->...h", u.float(), p["w_dt"].float())
        + p["dt_bias"])                                       # [..., Hs]
    A = -torch.exp(p["A_log"])                                # [Hs,P,N]
    Bmat = torch.einsum("...hp,hpn->...hn", *_promoted(u, p["w_B"]))
    a = torch.exp(dt[..., None, None] * A)                    # [..., Hs,P,N]
    b = (dt[..., None] * Bmat)[..., None, :] * u[..., None]   # [..., Hs,P,N]
    return a, b.float()


def _ssm_combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def mamba_seq(cfg: ModelConfig, p, x):
    """Parallel (train/prefill) pass.  x: [B,S,d] -> [B,S,d]."""
    cd = x.dtype
    B, S, d = x.shape
    Hs, P = cfg.ssm_heads, cfg.ssm_head_dim
    inner = Hs * P
    uz = x @ p["w_in"].to(cd)
    u, z = uz[..., :inner], uz[..., inner:]
    # depthwise causal conv over the sequence axis, the taps summed in order
    upad = zero_pad(u, (0, 0, _CONV_K - 1, 0))
    u = sum(upad[:, i:i + S] * p["w_conv"][i].to(cd)
            for i in range(_CONV_K))
    u = _silu(u).reshape(B, S, Hs, P)

    a, b = _mamba_gates(cfg, p, u)
    _, h = associative_scan(_ssm_combine, (a.float(), b), dim=1)
    C = torch.einsum("bshp,hpn->bshn", *_promoted(u, p["w_C"])).float()
    y = torch.einsum("bshpn,bshn->bshp", h, C).to(cd) \
        + p["D"].to(cd) * u
    y = y.reshape(B, S, inner) * _silu(z)
    return y @ p["w_out"].to(cd)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, device,
                     lead: tuple = ()):
    Hs, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "h": torch.zeros(lead + (batch, Hs, P, N), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(lead + (batch, _CONV_K - 1, Hs * P), dtype=dtype,
                            device=device),
    }


def mamba_step(cfg: ModelConfig, p, state, x_t):
    """One decode step.  x_t: [B,d] -> ([B,d], new state)."""
    cd = x_t.dtype
    B, d = x_t.shape
    Hs, P = cfg.ssm_heads, cfg.ssm_head_dim
    inner = Hs * P
    uz = x_t @ p["w_in"].to(cd)
    u, z = uz[..., :inner], uz[..., inner:]
    hist = torch.cat([state["conv"], u[:, None, :]], dim=1)  # [B,K,inner]
    u_c = sum(hist[:, i] * p["w_conv"][i].to(cd) for i in range(_CONV_K))
    u_c = _silu(u_c).reshape(B, Hs, P)

    if isinstance(u_c, DTensor):
        y, h = _mamba_head_sharded(cfg, p, state["h"], u_c)
    else:
        y, h = _mamba_head(cfg, p, state["h"], u_c)
    y = (y.reshape(B, inner) * _silu(z)) @ p["w_out"].to(cd)
    return y, {"h": h, "conv": hist[:, 1:]}


_HEAD_KEYS = ("w_dt", "dt_bias", "A_log", "w_B", "w_C", "D")


def _mamba_head(cfg: ModelConfig, p, h_prev, u_c):
    """The SSM update and read-out of one decode step: u_c [B,Hs,P] and
    the state h_prev [B,Hs,P,N] -> (y [B,Hs,P], the new state)."""
    a, b = _mamba_gates(cfg, p, u_c)
    h = a.float() * h_prev + b
    C = torch.einsum("bhp,hpn->bhn", *_promoted(u_c, p["w_C"])).float()
    y = torch.einsum("bhpn,bhn->bhp", h, C).to(u_c.dtype) \
        + p["D"].to(u_c.dtype) * u_c
    return y, h


def _mamba_head_sharded(cfg: ModelConfig, p, h_prev, u_c):
    """:func:`_mamba_head` on DTensors, on each shard's local tensors
    (``local_map``): the batch rows keep their shards and the SSM heads
    are gathered whole, with the head-sized params.  DTensor's own split
    of the heads is uneven (hymba's 25 over 16) and hands a view a
    non-contiguous local shard."""
    mesh = u_c.device_mesh
    rows = _hint_placements(u_c.shape, mesh, (BATCH_AXES,))
    state_rows = _hint_placements(h_prev.shape, mesh, (BATCH_AXES,))
    whole = (Replicate(),) * mesh.ndim

    def local(h_prev, u_c, *leaves):
        return _mamba_head(cfg, dict(zip(_HEAD_KEYS, leaves)), h_prev, u_c)

    return local_map(local, out_placements=(rows, state_rows),
                     in_placements=(state_rows, rows)
                     + (whole,) * len(_HEAD_KEYS),
                     device_mesh=mesh, redistribute_inputs=True)(
        h_prev, u_c, *(p[k] for k in _HEAD_KEYS))


# ---------------------------------------------------------------------------
# mLSTM (matrix memory)
# ---------------------------------------------------------------------------


def init_mlstm(gen, cfg: ModelConfig, dtype, lead: tuple = ()):
    """mLSTM block: pre-norm, up-projection (factor pf), q/k/v + i/f/o gates,
    matrix-memory mixing, gated down-projection.  Every leaf carries the
    leading dims ``lead``."""
    d = cfg.d_model
    H, hd = cfg.n_heads, cfg.head_dim
    dp = int(cfg.mlstm_proj_factor * d)
    s, sp = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dp)
    dev = gen.device
    bias = torch.cat([torch.zeros(H, device=dev), torch.full((H,), 3.0,
                                                             device=dev)])
    return {
        "norm": torch.ones(lead + (d,), dtype=dtype, device=dev),
        "w_up": init_normal(gen, lead + (d, 2 * dp), s, dtype),
        "w_qkv": init_normal(gen, lead + (dp, 3 * H * hd), sp, dtype),
        "w_if": init_normal(gen, lead + (dp, 2 * H), sp, torch.float32),
        "if_bias": bias.expand(lead + (2 * H,)).clone(),
        "w_og": init_normal(gen, lead + (dp, H * hd), sp, dtype),
        "w_down": init_normal(gen, lead + (H * hd, d),
                              1.0 / math.sqrt(H * hd), dtype),
    }


def _mlstm_qkvif(cfg: ModelConfig, p, xe):
    H, hd = cfg.n_heads, cfg.head_dim
    qkv = xe @ p["w_qkv"].to(xe.dtype)
    shape = xe.shape[:-1] + (H, hd)
    q, k, v = (t.reshape(shape) for t in qkv.chunk(3, dim=-1))
    i_f = xe.float() @ p["w_if"] + p["if_bias"]
    i_pre, f_pre = i_f.chunk(2, dim=-1)                        # [..., H]
    return q, k, v / math.sqrt(hd), i_pre, f_pre


def _cum_log_forget(f_pre: torch.Tensor) -> torch.Tensor:
    """The cumulative log-forget gate over the sequence, f_pre [B,S,H].
    On a DTensor it runs on each shard's local tensors with the sequence
    whole (``local_map``): DTensor has no rule for logsigmoid's backward,
    nor on some torch versions for the flip in cumsum's."""
    if not isinstance(f_pre, DTensor):
        return torch.cumsum(F.logsigmoid(f_pre), dim=1)
    pl = tuple(Replicate() if p.is_partial() or p == Shard(1) else p
               for p in f_pre.placements)
    return local_map(lambda f: torch.cumsum(F.logsigmoid(f), dim=1),
                     out_placements=(pl,), in_placements=(pl,),
                     device_mesh=f_pre.device_mesh,
                     redistribute_inputs=True)(f_pre)


def _mlstm_parallel_block(q_c, F_c, k, v, Fcum, i_pre, t0: int):
    """One query chunk of the mLSTM parallel form (fp32 in/out).

    q_c: [B,c,H,hd] queries for rows [t0, t0+c); F_c their cumulative
    log-forget; k/v/Fcum/i_pre: full-sequence tensors.  Only the [c, S]
    decay slab materialises.  Query rows context-parallelise over the
    "model" axis on a mesh (4 mLSTM heads never tile it)."""
    if not os.environ.get("REPRO_NAIVE_SHARDING"):
        q_c = shard_hint(q_c, BATCH_AXES, "model", None, None)
        F_c = shard_hint(F_c, BATCH_AXES, "model", None)
    return _mlstm_block_local(q_c, F_c, k, v, Fcum, i_pre, t0)


def _mlstm_sharded(q_r, F_r, k, v, Fcum, i_pre, t0: int, chunk: int, *,
                   naive: bool):
    """Query rows [t0, t0 + n) of the parallel form on DTensors: each
    device takes its batch rows and (unless naive) its share of the query
    rows over ``"model"`` (the row split of the reference's
    ``_mlstm_parallel_block`` hints), against the full sequence of
    k/v/Fcum/i_pre, ``chunk`` rows at a time on local tensors
    (``local_map``).  DTensor's own propagation through the block's
    einsums does not finish (strided placements)."""
    mesh = q_r.device_mesh
    rows_ax = (BATCH_AXES,) if naive else (BATCH_AXES, "model")
    q_pl = _hint_placements(q_r.shape, mesh, rows_ax)
    F_pl = _hint_placements(F_r.shape, mesh, rows_ax)
    full4 = _hint_placements(k.shape, mesh, (BATCH_AXES,))
    full3 = _hint_placements(Fcum.shape, mesh, (BATCH_AXES,))
    split = Shard(1) in q_pl

    def local(q_r, F_r, k, v, Fcum, i_pre):
        n = q_r.shape[1]
        off = t0 + (mesh.get_local_rank("model") * n if split else 0)
        c = chunk if n % chunk == 0 else n
        return torch.cat([_mlstm_block_local(
            q_r[:, t:t + c], F_r[:, t:t + c], k, v, Fcum, i_pre, off + t)
            for t in range(0, n, c)], dim=1)

    # the query rows are gathered back, as in layers._sdpa_sharded
    out_pl = tuple(Replicate() if p == Shard(1) else p for p in q_pl)
    out = local_map(local, out_placements=(q_pl,),
                    in_placements=(q_pl, F_pl, full4, full4, full3, full3),
                    device_mesh=mesh, redistribute_inputs=True)(
        q_r, F_r, k, v, Fcum, i_pre)
    return out.redistribute(mesh, out_pl)


def _mlstm_block_local(q_c, F_c, k, v, Fcum, i_pre, t0: int):
    """The block's arithmetic on plain tensors (rows [t0, t0 + c))."""
    S = k.shape[1]
    # D[b,h,t,s] = F_t - F_s + i_s  for s <= t   (log decay matrix)
    D = F_c.transpose(1, 2)[..., :, None] \
        - Fcum.transpose(1, 2)[..., None, :] \
        + i_pre.transpose(1, 2)[..., None, :]                 # [B,H,c,S]
    t_idx = t0 + torch.arange(q_c.shape[1], device=q_c.device)
    causal = t_idx[:, None] >= torch.arange(S, device=q_c.device)[None, :]
    D = D.masked_fill(~causal, float("-inf"))
    m = D.amax(dim=-1, keepdim=True)                          # stabiliser
    w = torch.exp(D - m)
    scores = torch.einsum("bthd,bshd->bhts", q_c, k) * w
    norm = torch.maximum(scores.sum(dim=-1, keepdim=True).abs(),
                         torch.exp(-m))
    return torch.einsum("bhts,bshd->bthd", scores / norm, v)  # [B,c,H,hd]


def mlstm_seq(cfg: ModelConfig, p, x):
    """Parallel form over the full sequence.  x: [B,S,d] -> [B,S,d]."""
    cd = x.dtype
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    xe, zg = (rms_norm(x, p["norm"], cfg.norm_eps)
              @ p["w_up"].to(cd)).chunk(2, dim=-1)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(cfg, p, xe)
    q, k, v = q.float(), k.float(), v.float()
    Fcum = _cum_log_forget(f_pre)                             # [B,S,H]

    if cfg.use_flash_kernel:
        y = kops.mlstm(q, k, v, Fcum, i_pre)
    elif isinstance(q, DTensor):     # one local_map for all the chunks
        y = _mlstm_sharded(q, Fcum, k, v, Fcum, i_pre, 0, cfg.q_chunk or S,
                           naive=bool(os.environ.get("REPRO_NAIVE_SHARDING")))
    else:
        chunk = cfg.q_chunk if (cfg.q_chunk and S > cfg.q_chunk
                                and S % cfg.q_chunk == 0) else S
        y = torch.cat([_mlstm_parallel_block(
            q[:, t0:t0 + chunk], Fcum[:, t0:t0 + chunk], k, v, Fcum, i_pre,
            t0) for t0 in range(0, S, chunk)], dim=1)
    y = y.reshape(B, S, H * hd).to(cd)
    y = y * F.silu(zg @ p["w_og"].to(cd))              # z-branch output gate
    return x + y @ p["w_down"].to(cd)


def init_mlstm_state(cfg: ModelConfig, batch: int, device,
                     lead: tuple = ()):
    H, hd = cfg.n_heads, cfg.head_dim
    z = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros(lead + (batch, H, hd, hd), **z),
        "n": torch.zeros(lead + (batch, H, hd), **z),
        "m": torch.full(lead + (batch, H), -1e30, **z),
    }


def mlstm_step(cfg: ModelConfig, p, state, x_t):
    """O(1) decode recurrence.  x_t: [B,d] -> ([B,d], new state)."""
    cd = x_t.dtype
    B, d = x_t.shape
    H, hd = cfg.n_heads, cfg.head_dim
    xe, zg = (rms_norm(x_t, p["norm"], cfg.norm_eps)
              @ p["w_up"].to(cd)).chunk(2, dim=-1)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(cfg, p, xe)
    q, k, v = q.float(), k.float(), v.float()
    logf = F.logsigmoid(f_pre)                                # [B,H]
    m_new = torch.maximum(logf + state["m"], i_pre)
    f_s = torch.exp(logf + state["m"] - m_new)
    i_s = torch.exp(i_pre - m_new)
    C = f_s[..., None, None] * state["C"] \
        + i_s[..., None, None] * torch.einsum("bhk,bhv->bhkv", k, v)
    n = f_s[..., None] * state["n"] + i_s[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C, q)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, H * hd).to(cd)
    y = y * F.silu(zg @ p["w_og"].to(cd))              # z-branch output gate
    return x_t + y @ p["w_down"].to(cd), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory)
# ---------------------------------------------------------------------------


def init_slstm(gen, cfg: ModelConfig, dtype, lead: tuple = ()):
    """sLSTM block: recurrent scalar-memory cell + post up/down MLP (pf 4/3).
    Every leaf carries the leading dims ``lead``."""
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    dff = int(d * 4 / 3)
    s = 1.0 / math.sqrt(d)
    return {
        "norm": torch.ones(lead + (d,), dtype=dtype, device=gen.device),
        "w_x": init_normal(gen, lead + (d, 4 * d), s, dtype),
        "r_h": init_normal(gen, lead + (H, dh, 4 * dh), 1.0 / math.sqrt(dh),
                           dtype),
        "w_up": init_normal(gen, lead + (d, dff), s, dtype),
        "w_down": init_normal(gen, lead + (dff, d), 1.0 / math.sqrt(dff),
                              dtype),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device,
                     lead: tuple = ()):
    H = cfg.n_heads
    shape = lead + (batch, H, cfg.d_model // H)
    z = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **z), "n": torch.zeros(shape, **z),
            "h": torch.zeros(shape, **z), "m": torch.full(shape, -1e30, **z)}


def _slstm_cell(cfg: ModelConfig, p, state, gx):
    """gx: [B, 4*d] pre-activations from the input path."""
    B = gx.shape[0]
    H = cfg.n_heads
    dh = cfg.d_model // H
    rh = torch.einsum("bhd,hdk->bhk", state["h"].to(p["r_h"].dtype), p["r_h"])
    g = gx.reshape(B, H, 4 * dh).float() + rh.float()
    i_pre, f_pre, z_pre, o_pre = g.chunk(4, dim=-1)           # [B,H,dh]
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(logf + state["m"] - m_new)
    c = f_s * state["c"] + i_s * torch.tanh(z_pre)
    n = f_s * state["n"] + i_s
    h = torch.sigmoid(o_pre) * c / n.clamp_min(1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_out(p, x, h):
    """The post up/down MLP on the cell outputs h, plus the residual."""
    cd = x.dtype
    y = h.reshape(x.shape).to(cd)
    y = F.gelu(y @ p["w_up"].to(cd), approximate="tanh") @ p["w_down"].to(cd)
    return x + y


def _slstm_loop(cfg: ModelConfig, r_h, gx):
    """The cell over time on plain tensors.  gx: [B,S,4d] -> h [B,S,H,dh]."""
    B, S = gx.shape[:2]
    state = init_slstm_state(cfg, B, gx.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(cfg, {"r_h": r_h}, state, gx[:, t])
        hs.append(state["h"])
    return torch.stack(hs, dim=1)


def _slstm_scan(cfg: ModelConfig, r_h, gx):
    """The loop on real tensors; on fake ones (the dry-run) one op that
    stands for it, priced as the loop (``models/slstm_scan.py``)."""
    if isinstance(gx, FakeTensor):
        return slstm_scan(r_h, gx)
    return _slstm_loop(cfg, r_h, gx)


def slstm_seq(cfg: ModelConfig, p, x):
    """Sequential pass over time.  x: [B,S,d] -> [B,S,d].

    On a DTensor the scan runs on each shard's local tensors under
    ``local_map``, after one redistribute of its inputs: gx keeps its
    batch shards and gathers every other dim, r_h is gathered whole (a
    dozen ops a step through sharding propagation would never finish at
    S = 4096)."""
    gx = rms_norm(x, p["norm"], cfg.norm_eps) @ p["w_x"].to(x.dtype)
    if isinstance(gx, DTensor):
        rows = tuple(pl if pl == Shard(0) else Replicate()
                     for pl in gx.placements)
        whole = (Replicate(),) * len(rows)
        scan = local_map(functools.partial(_slstm_scan, cfg),
                         out_placements=(rows,), in_placements=(whole, rows),
                         device_mesh=gx.device_mesh, redistribute_inputs=True)
        hs = scan(p["r_h"], gx)
    else:
        hs = _slstm_scan(cfg, p["r_h"], gx)
    return _slstm_out(p, x, hs)


def slstm_step(cfg: ModelConfig, p, state, x_t):
    """One decode step.  x_t: [B,d] -> ([B,d], new state)."""
    gx = rms_norm(x_t, p["norm"], cfg.norm_eps) @ p["w_x"].to(x_t.dtype)
    new = _slstm_cell(cfg, p, state, gx)
    return _slstm_out(p, x_t, new["h"]), new
