"""Fine-grained mixture-of-experts layer (DeepSeekMoE / Kimi-K2 style) on
torch tensors.

The port of ``repro/models/moe.py``.  Token-choice top-k routing with
capacity-factor dropping, as there: sort the token-expert pairs by expert
id, scatter them into a dense [E, C, d] buffer (row ``E * C`` takes every
dropped pair and is thrown away), run all experts as one batched product,
gather back and combine with the normalised router weights.  Shared
experts (DeepSeekMoE's "2 shared + 64 routed") are one always-on SwiGLU
MLP of width ``n_shared * d_expert``.  Returns the Switch-style
load-balance auxiliary loss beside the output.

The reference combines with a scatter-add of the sorted pairs into a
zero buffer, which XLA applies in the order of the updates: each token's
k contributions add one after another in ascending expert id.  The port
lays them out as [T, k] in that order and sums them the same way, so the
result does not depend on the order of atomic adds on the card.  The
router and its softmax run in float32 (the init pins ``router`` to
float32); the experts' weights are cast to the compute dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (BATCH_AXES, init_mlp, init_normal, mlp,
                                       on_mesh, shard_hint)


def init_moe(gen, cfg: ModelConfig, dtype, lead: tuple = ()):
    """Router, routed experts and the fused shared experts, each leaf with
    leading dims ``lead``."""
    E, d, de = cfg.n_experts, cfg.d_model, cfg.d_expert
    s = 1.0 / math.sqrt(d)
    p = {
        "router": init_normal(gen, lead + (d, E), s, torch.float32),
        "we_gate": init_normal(gen, lead + (E, d, de), s, dtype),
        "we_up": init_normal(gen, lead + (E, d, de), s, dtype),
        "we_down": init_normal(gen, lead + (E, de, d), 1.0 / math.sqrt(de),
                               dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.n_shared_experts * de, "swiglu",
                               dtype, lead)
    return p


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens (Python's ``round``: half to even)."""
    k = cfg.top_k
    return int(max(k, round(T * k / cfg.n_experts * cfg.capacity_factor)))


def route(cfg: ModelConfig, p, xt: torch.Tensor) -> tuple:
    """Router of xt [T, d]: float32 ``probs`` [T, E] and each token's
    ``top_p`` (normalised over its k) and ``top_i`` [T, k]."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_i


def expert_counts(e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """How many entries of the int64 ids ``e`` name each expert (int64
    [E]; ``torch.bincount``'s counts through a scatter-add, which DTensor
    shards where it has no bincount)."""
    return e.new_zeros(n_experts).scatter_add(0, e, torch.ones_like(e))


def dispatch(top_i: torch.Tensor, n_experts: int, cap: int) -> tuple:
    """The token-expert pairs sorted by expert (stable): their ``order``
    in the flattened [T * k] pairs, whether each is kept (its rank within
    its expert below ``cap``) and its ``slot`` in the [E * cap + 1] buffer
    (the last row for a dropped pair).  One global sort over all T * k
    pairs, as the reference's: on a mesh the ids are gathered first."""
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # start of each expert's run: the exclusive cumsum of the counts
    counts = expert_counts(sorted_e, n_experts)
    first_of = (torch.cumsum(counts, 0) - counts)[sorted_e]
    rank = torch.arange(flat_e.numel(), device=flat_e.device) - first_of
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    return order, keep, slot


def put_rows(n: int, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """A zero [n, ...] tensor with row ``idx[i]`` set to ``src[i]``
    (int64 ``idx``; where ids repeat, as the dropped pairs' last row does,
    the kept value is index_put's).  On a DTensor it runs on each shard's
    local tensors (``local_map``), the rows gathered whole and any split
    of the other dims kept: DTensor has no in-place index_put rule on
    every torch version."""
    on = next((t for t in (src, idx) if isinstance(t, DTensor)), None)
    if on is None:
        buf = src.new_zeros((n,) + tuple(src.shape[1:]))
        buf[idx] = src
        return buf
    mesh = on.device_mesh
    whole = (Replicate(),) * mesh.ndim
    idx, src = on_mesh(idx, mesh), on_mesh(src, mesh)
    pl = tuple(p if isinstance(p, Shard) and p.dim > 0 else Replicate()
               for p in src.placements)

    def local(i, s):
        buf = s.new_zeros((n,) + tuple(s.shape[1:]))
        buf[i] = s
        return buf

    return local_map(local, out_placements=(pl,), in_placements=(whole, pl),
                     device_mesh=mesh, redistribute_inputs=True)(idx, src)


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor) -> tuple:
    """x: [B, S, d] -> (out [B, S, d], aux_loss float32 scalar)."""
    cd = x.dtype
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    probs, top_p, top_i = route(cfg, p, xt)

    # ---- dispatch: sort token-expert pairs by expert ----------------------
    cap = capacity(cfg, T)
    order, keep, slot = dispatch(top_i, E, cap)
    tok_of = order // k
    buf = put_rows(E * cap + 1, slot, xt[tok_of])
    h = buf[: E * cap].view(E, cap, d)

    # ---- all experts as one batched product -------------------------------
    g = torch.bmm(h, p["we_gate"].to(cd))
    u = torch.bmm(h, p["we_up"].to(cd))
    y = torch.bmm(F.silu(g) * u, p["we_down"].to(cd))

    # ---- combine: each token's k pairs summed in ascending expert id ------
    y_flat = torch.cat([y.reshape(E * cap, d), y.new_zeros((1, d))])
    weight = top_p.reshape(-1)[order] * keep.float()
    contrib = y_flat[slot] * weight[:, None].to(cd)        # sorted pairs
    sorted_pos = put_rows(T * k, order,
                          torch.arange(T * k, device=x.device))
    per_tok = contrib[sorted_pos.view(T, k).sort(dim=1).values]  # [T, k, d]
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]

    if cfg.n_shared_experts:
        # on a mesh both terms batch-split first: the routed sum comes out
        # of the global dispatch whole, the shared MLP's split by batch
        out = shard_hint(out, BATCH_AXES) \
            + shard_hint(mlp(p["shared"], xt, "swiglu"), BATCH_AXES)

    # ---- Switch-style load-balance loss -----------------------------------
    frac = expert_counts(top_i.reshape(-1), E).float() / (T * k)
    aux = E * (frac * probs.mean(dim=0)).sum() * cfg.router_aux_coef
    return out.reshape(B, S, d), aux
