"""Transformer building blocks on torch tensors (pure functions + dict params).

The port of ``repro/models/layers.py``, function for function:

  * ``rms_norm``          -- RMSNorm in fp32, in plain torch as in the
                             reference (K7 sits behind
                             ``kernels.ops.rmsnorm``, which no model calls)
  * ``apply_rope``        -- rotary embeddings, "full" (llama) or "half"
                             (chatglm 2d-rope: only the first half of the
                             head dim rotates)
  * ``attention``         -- GQA self-attention with optional sliding
                             window, logit softcap (gemma2) and a KV cache
                             with absolute slot positions (supports rolling
                             caches), and cross-attention (whisper);
                             self-attention prefill goes through the K5
                             kernel when ``cfg.use_flash_kernel``
  * ``mlp``               -- swiglu / geglu / gelu feed-forward, in plain
                             torch in the compute dtype as in the
                             reference (K8 is ``kernels.ops.swiglu``)

``shard_hint`` is the reference's layout constraint: the identity on a
plain tensor, a ``redistribute`` on a DTensor (the production dry-run,
``launch/dryrun.py``).  Windows are Python ints here (the port runs its
layer stack as a Python loop), so the K5 branch of ``attention`` is live
for every layer.  ``bf16_grad_barrier`` is the reference's identity whose
backward casts the cotangent to bfloat16 (no model calls it, as in the
reference).

Params are drawn from a ``torch.Generator`` (:func:`generator`); on the
``meta`` device, which has none, the init functions draw nothing and
return shape-only tensors.
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# activation-sharding hints
# ---------------------------------------------------------------------------

BATCH_AXES = ("pod", "data")


def shard_hint(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's sharding constraint, degrading gracefully: each
    entry of ``axes`` is None | axis-name | tuple-of-names; an axis is
    applied only if it exists in x's mesh and divides the dim, and mesh
    axes not named are replicated.  On a plain tensor (no mesh) this is
    the identity, so models stay mesh-agnostic; on a DTensor it is a
    ``redistribute`` to those placements (a collective where they
    differ)."""
    if not isinstance(x, DTensor):
        return x
    target = _hint_placements(x.shape, x.device_mesh, axes)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def _hint_placements(shape, mesh, axes) -> tuple:
    """The DTensor placements ``shard_hint(x, *axes)`` gives a tensor of
    ``shape`` on ``mesh``."""
    from repro_torch.dist.sharding import P, placements
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    spec = []
    for dim, ax in zip(shape, axes):
        if ax is None:
            spec.append(None)
            continue
        cand = tuple(a for a in ((ax,) if isinstance(ax, str) else ax)
                     if a in names)
        size = math.prod(sizes[a] for a in cand)
        if cand and size > 1 and dim % size == 0:
            spec.append(cand if len(cand) > 1 else cand[0])
        else:
            spec.append(None)
    return placements(P(*spec), mesh)


def on_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh``: a plain tensor, the same on every
    device, replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def _model_axis_size(x: torch.Tensor) -> int:
    """Size of the ``"model"`` axis of x's mesh (1 off a mesh)."""
    if not isinstance(x, DTensor):
        return 1
    names = tuple(x.device_mesh.mesh_dim_names or ())
    if "model" not in names:
        return 1
    return int(x.device_mesh.shape[names.index("model")])


class _BF16GradBarrier(torch.autograd.Function):
    """Identity forward; casts the cotangent to bf16 on the way back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def bf16_grad_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; casts the cotangent to bf16 on the way back.

    Placed at block boundaries it pins the backward residual stream to
    bf16 instead of the fp32 that loss-side upcasts otherwise propagate
    (the reference's ``jax.custom_vjp`` of the same name).  PyTorch's
    autograd hands a leaf its gradient in the leaf's own dtype, so below a
    float32 input the cotangent carries bf16 values in float32 storage,
    where the reference's stays a bf16 array."""
    return _BF16GradBarrier.apply(x)


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype named like the config's ``"float32"``/``"int8"``."""
    return getattr(torch, name)


class _ShapeOnly:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, which
    has none: the init functions read its ``device`` and draw nothing."""

    def __init__(self, device: torch.device):
        self.device = device


def generator(device: torch.device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (a
    shape-only stand-in on the ``meta`` device)."""
    if device.type == "meta":
        return _ShapeOnly(device)
    return torch.Generator(device=device).manual_seed(seed)


def init_normal(gen: torch.Generator, shape: tuple, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """Standard-normal float32 draws on the generator's device, times
    ``scale``, cast to ``dtype`` (the reference's init recipe)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)         # in place: one leaf-sized buffer


def init_uniform(gen: torch.Generator, shape: tuple,
                 dtype: torch.dtype) -> torch.Tensor:
    """Uniform float32 draws in [0, 1) on the generator's device, cast to
    ``dtype``."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# norms & embeddings
# ---------------------------------------------------------------------------


def init_rms_norm(d: int, dtype, device, lead: tuple = ()) -> torch.Tensor:
    return torch.ones(lead + (d,), dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             cast_early: bool = False) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    if cast_early:
        # normalise in fp32 but leave the scale-mul in compute dtype
        y = (x32 * torch.rsqrt(var + eps)).to(dt)
        return y * scale.to(dt)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(dt)


def init_embedding(gen, vocab: int, d: int, dtype) -> torch.Tensor:
    return init_normal(gen, (vocab, d), 0.02, dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``tokens`` (``F.embedding``: its backward sums
    each row's gradients in a fixed order, which indexing's accumulating
    backward does not on the CPU).  On a DTensor the table's ZeRO shards
    (its ``"data"`` axis) are gathered first, as DTensor's masked gather
    takes a table split over one mesh axis, not two; the rows come out
    batch-sharded with every other axis summed or gathered."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    table = table.redistribute(table.device_mesh, tuple(
        Replicate() if name == "data" else pl for name, pl in
        zip(table.device_mesh.mesh_dim_names, table.placements)))
    return shard_hint(F.embedding(tokens, table), BATCH_AXES)


def zero_pad(t: torch.Tensor, pads: tuple) -> torch.Tensor:
    """``F.pad(t, pads)`` with zeros.  On a DTensor the pad runs on each
    shard's local tensor (``local_map``), the padded dims gathered whole
    first where they are split: DTensor's pad rule fails on some torch
    versions."""
    if not isinstance(t, DTensor):
        return F.pad(t, pads)
    dims = {t.ndim - 1 - i for i in range(len(pads) // 2)
            if pads[2 * i] or pads[2 * i + 1]}
    pl = tuple(Replicate() if p.is_partial() or (isinstance(p, Shard)
                                                 and p.dim in dims) else p
               for p in t.placements)
    return local_map(lambda x: F.pad(x, pads), out_placements=(pl,),
                     in_placements=(pl,), device_mesh=t.device_mesh,
                     redistribute_inputs=True)(t)


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position embeddings [seq, d]."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    log_base = torch.log(torch.tensor(10000.0, device=device))
    inv = torch.exp(-log_base * dim / max(d // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def _rope_rotate(x: torch.Tensor, positions: torch.Tensor,
                 theta: float) -> torch.Tensor:
    """Rotate all of the last dim of x [..., S, H, D] at ``positions`` [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs                 # [..., S, half]
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mode: str) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] absolute token positions."""
    if mode == "none":
        return x
    if mode == "full":
        return _rope_rotate(x, positions, theta)
    if mode == "half":                           # chatglm 2d rope
        d = x.shape[-1]
        rotated = _rope_rotate(x[..., : d // 2], positions, theta)
        return torch.cat([rotated, x[..., d // 2:]], dim=-1)
    raise ValueError(f"unknown rope mode {mode}")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Decode-time cache with absolute slot positions (rolling-capable).

    ``k``/``v``: [..., B, Smax, K, hd]; ``pos``: [..., B, Smax] absolute
    position held in each slot, -1 when the slot is empty (leading dims:
    the layer stack).  A rolling cache writes at slot ``position % Smax``.

    int8 mode: k/v stored int8 with per-(batch, slot, head) symmetric fp32
    scales.  Unlike the reference, which returns an updated copy, decode
    writes into the cache's tensors in place (saving a cache-sized copy per
    layer and step) and returns the same cache."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    k_scale: torch.Tensor | None = None     # [..., B, Smax, K], int8 only
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer(self, i: int) -> "KVCache":
        """Views of layer ``i`` of a stacked cache (writes reach the stack)."""
        return KVCache(*(None if t is None else t[i] for t in (
            self.k, self.v, self.pos, self.k_scale, self.v_scale)))


def write_slots(buf: torch.Tensor, slots: torch.Tensor,
                val: torch.Tensor) -> None:
    """``buf[b, slots[b, j]] = val[b, j]`` for every row b, in place (buf
    [B, Smax, ...], slots [B, S], val [B, S, ...]).

    On a DTensor each shard writes its own rows: DTensor refuses an
    in-place index_put that would move buf's placements.  val is placed
    like buf (its S dim replicated), slots like buf's batch dim; where the
    slot axis is split (long-context ``seq_shard`` caches) a shard writes
    only the slots in its range."""
    if not isinstance(buf, DTensor):
        bidx = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[bidx, slots] = val
        return
    mesh, pl = buf.device_mesh, tuple(buf.placements)
    val_l = val.redistribute(mesh, tuple(
        Replicate() if p == Shard(1) else p for p in pl)).to_local()
    slots_l = slots.redistribute(mesh, tuple(
        p if p == Shard(0) else Replicate() for p in pl)).to_local()
    buf_l = buf.to_local()
    block, coord = 0, mesh.get_coordinate()
    for d, p in enumerate(pl):          # major to minor over the mesh
        if p == Shard(1):
            block = block * mesh.shape[d] + coord[d]
    n = buf_l.shape[1]
    off = block * n
    bidx = torch.arange(buf_l.shape[0], device=buf_l.device)[:, None]
    local = slots_l - off
    mine = (local >= 0) & (local < n)
    local = local.clamp(0, n - 1)
    mine = mine.reshape(mine.shape + (1,) * (val_l.dim() - 2))
    buf_l[bidx, local] = torch.where(mine, val_l, buf_l[bidx, local])


def init_kv_cache(batch: int, max_slots: int, n_kv: int, head_dim: int,
                  dtype, device, lead: tuple = ()) -> KVCache:
    shape = lead + (batch, max_slots, n_kv, head_dim)
    scales = [torch.zeros(shape[:-1], dtype=torch.float32, device=device)
              for _ in range(2)] if dtype == torch.int8 else [None, None]
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.full(shape[:-2], -1, dtype=torch.int32, device=device),
        *scales)


def _quantize_kv(x):
    """x: [B, S, K, hd] -> (int8 values, per-[B,S,K] scales).  torch.round
    rounds half to even, as jnp.round does."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) / 127.0
    safe = scale.clamp_min(1e-9)
    q = torch.round(x32 / safe[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def init_attn(gen, cfg: ModelConfig, dtype, lead: tuple = (), *,
              n_heads: int | None = None, n_kv: int | None = None):
    h = n_heads or cfg.n_heads
    k = n_kv or cfg.n_kv_heads
    d, hd = cfg.d_model, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    return {
        "wq": init_normal(gen, lead + (d, h * hd), s, dtype),
        "wk": init_normal(gen, lead + (d, k * hd), s, dtype),
        "wv": init_normal(gen, lead + (d, k * hd), s, dtype),
        "wo": init_normal(gen, lead + (h * hd, d), s, dtype),
    }


def _sdpa(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
          softcap: float, compute_dtype) -> torch.Tensor:
    """Reference scaled-dot-product attention with GQA + masks.

    q: [B,Sq,H,hd]; k/v: [B,Skv,Kh,hd]; q_pos: [B,Sq]; k_pos: [B,Skv]
    (absolute positions; k_pos = -1 marks invalid slots); window 0 =
    unlimited.  On DTensors, :func:`_sdpa_sharded`."""
    if isinstance(q, DTensor):
        return _sdpa_sharded(q, k, v, q_pos, k_pos, causal=causal,
                             window=window, softcap=softcap,
                             compute_dtype=compute_dtype)
    B, Sq, H, hd = q.shape
    Kh = k.shape[2]
    G = H // Kh
    qg = q.reshape(B, Sq, Kh, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    logits = logits / math.sqrt(hd)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)

    valid = (k_pos >= 0)[:, None, :]                           # [B,1,Skv]
    if causal:
        rel = q_pos[:, :, None] - k_pos[:, None, :]            # [B,Sq,Skv]
        valid = valid & (rel >= 0)
        if window > 0:
            valid = valid & (rel < window)
    logits = logits.masked_fill(~valid[:, None, None], -1e30)
    p = torch.softmax(logits, dim=-1).to(compute_dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return out.reshape(B, Sq, H * hd)


def _sdpa_sharded(q, k, v, q_pos, k_pos, *, q_chunk=0,
                  **kw) -> torch.Tensor:
    """:func:`_sdpa_auto` on DTensors: each device attends its own batch
    rows and its own heads on its local tensors (``local_map``; its query
    rows ``q_chunk`` at a time), as GSPMD partitions the reference's
    einsums.

    Heads go over the ``"model"`` axis when the KV heads tile it; else
    the query heads do, k/v are gathered whole and each device picks the
    KV head of each of its query heads; where the query heads do not tile
    it either, the query rows do (context parallel).  DTensor's own
    propagation through the GQA einsums merges sharded dims into strided
    placements, whose redistribution search does not finish."""
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)
    m = mesh.shape[names.index("model")] if "model" in names else 1
    H, Kh = q.shape[2], k.shape[2]
    pick = m > 1 and Kh % m != 0 and H % m == 0
    if m > 1 and H % m != 0:                       # context parallel
        q_ax, kv_ax = (BATCH_AXES, "model"), (BATCH_AXES,)
    else:
        q_ax = (BATCH_AXES, None, "model")
        kv_ax = (BATCH_AXES,) if pick else q_ax
    q_pl = _hint_placements(q.shape, mesh, q_ax)
    kv_pl = _hint_placements(k.shape, mesh, kv_ax)
    rows = _hint_placements(q_pos.shape, mesh, q_ax[:2])
    k_rows = _hint_placements(k_pos.shape, mesh, (BATCH_AXES,))

    def local(q, k, v, q_pos, k_pos):
        if pick:                  # the KV head of each local query head
            r = mesh.get_local_rank("model")
            h = r * q.shape[2] + torch.arange(q.shape[2], device=q.device)
            idx = h // (H // Kh)
            k, v = k[:, :, idx], v[:, :, idx]
        Sq = q.shape[1]
        if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
            return _sdpa_q_chunked(q, k, v, q_pos, k_pos, q_chunk=q_chunk,
                                   **kw)
        return _sdpa(q, k, v, q_pos, k_pos, **kw)

    # split query rows are gathered back: the [B, S] dims are flattened
    # into one for the output projection, where a row split under the
    # batch split is a strided placement DTensor cannot plan around
    out_pl = tuple(Replicate() if p == Shard(1) else p for p in q_pl)
    out = local_map(local, out_placements=(q_pl,),
                    in_placements=(q_pl, kv_pl, kv_pl, rows, k_rows),
                    device_mesh=mesh, redistribute_inputs=True)(
        q, *(on_mesh(t, mesh) for t in (k, v, q_pos, k_pos)))
    return out.redistribute(mesh, out_pl)


def _sdpa_q_chunked(q, k, v, q_pos, k_pos, *, causal, window, softcap,
                    compute_dtype, q_chunk, cp=False):
    """The [Sq, Skv] score matrix one query chunk at a time ([q_chunk, Skv]
    slabs); numerically identical to :func:`_sdpa`.  A plain loop (the
    reference scans with remat for the backward)."""
    outs = []
    for i in range(0, q.shape[1], q_chunk):
        qc = q[:, i:i + q_chunk]
        if cp:
            # context-parallel fallback (heads don't tile the model axis):
            # split this chunk's query rows over "model"; k/v replicated.
            qc = shard_hint(qc, BATCH_AXES, "model", None, None)
        outs.append(_sdpa(qc, k, v, q_pos[:, i:i + q_chunk], k_pos,
                          causal=causal, window=window, softcap=softcap,
                          compute_dtype=compute_dtype))
    return torch.cat(outs, dim=1)


def _sdpa_auto(q, k, v, q_pos, k_pos, *, causal, window, softcap,
               compute_dtype, q_chunk, n_heads=0):
    Sq = q.shape[1]
    # heads that don't tile the model axis can't head-shard the einsum;
    # shard the query sequence instead (each q row attends the full kv)
    ms = _model_axis_size(q)
    cp = bool(ms > 1 and n_heads and n_heads % ms != 0
              and not os.environ.get("REPRO_NAIVE_SHARDING"))
    if cp:
        k = shard_hint(k, BATCH_AXES, None, None, None)
        v = shard_hint(v, BATCH_AXES, None, None, None)
    if isinstance(q, DTensor):        # one local_map for all the chunks
        return _sdpa_sharded(q, k, v, q_pos, k_pos, causal=causal,
                             window=window, softcap=softcap,
                             compute_dtype=compute_dtype, q_chunk=q_chunk)
    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        return _sdpa_q_chunked(q, k, v, q_pos, k_pos, causal=causal,
                               window=window, softcap=softcap,
                               compute_dtype=compute_dtype, q_chunk=q_chunk,
                               cp=cp)
    if cp:
        q = shard_hint(q, BATCH_AXES, "model", None, None)
    out = _sdpa(q, k, v, q_pos, k_pos, causal=causal, window=window,
                softcap=softcap, compute_dtype=compute_dtype)
    return out if not cp else shard_hint(out, BATCH_AXES, None, None)


def attention(cfg: ModelConfig, p, x, q_pos, *, window: int = 0,
              cache: KVCache | None = None,
              enc_out: torch.Tensor | None = None, rope: bool = True,
              causal: bool = True) -> tuple:
    """Self- or cross-attention.  Returns (output, cache).

    ``cache`` given => decode: x holds the new token(s); K/V are written
    into the cache (in place) at slot ``q_pos % Smax``.  ``enc_out``
    given => cross-attention (no mask, no rope, no cache, never K5: the
    reference sends only self-attention prefill to its kernel)."""
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(cd)).reshape(B, S, h, hd)
    kv_src = enc_out if enc_out is not None else x
    Skv = kv_src.shape[1]
    k = (kv_src @ p["wk"].to(cd)).reshape(B, Skv, kh, hd)
    v = (kv_src @ p["wv"].to(cd)).reshape(B, Skv, kh, hd)

    if enc_out is not None:
        k_pos = torch.zeros((B, Skv), dtype=torch.int32, device=x.device)
        out = _sdpa_auto(q, k, v, q_pos, k_pos, causal=False, window=0,
                         softcap=cfg.attn_softcap, compute_dtype=cd,
                         q_chunk=cfg.q_chunk, n_heads=cfg.n_heads)
        return out @ p["wo"].to(cd), None

    if rope:
        q = apply_rope(q, q_pos, cfg.rope_theta, cfg.rope)
        k = apply_rope(k, q_pos, cfg.rope_theta, cfg.rope)

    if cache is None:
        if cfg.use_flash_kernel and S >= 128:
            out = kops.flash_attention(q, k, v, causal=causal,
                                       window=int(window),
                                       softcap=cfg.attn_softcap)
            return out.reshape(B, S, h * hd) @ p["wo"].to(cd), None
        out = _sdpa_auto(q, k, v, q_pos, q_pos, causal=causal, window=window,
                         softcap=cfg.attn_softcap, compute_dtype=cd,
                         q_chunk=cfg.q_chunk, n_heads=cfg.n_heads)
        return out @ p["wo"].to(cd), None

    # decode: write S new token(s) into slots q_pos % Smax, attend over cache
    smax = cache.k.shape[1]
    slots = q_pos % smax                                       # [B,S]
    write_slots(cache.pos, slots, q_pos.to(torch.int32))
    if cache.quantized:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        write_slots(cache.k, slots, kq)
        write_slots(cache.v, slots, vq)
        write_slots(cache.k_scale, slots, ks)
        write_slots(cache.v_scale, slots, vs)
        k_full = _dequantize_kv(cache.k, cache.k_scale, cd)
        v_full = _dequantize_kv(cache.v, cache.v_scale, cd)
    else:
        write_slots(cache.k, slots, k.to(cache.k.dtype))
        write_slots(cache.v, slots, v.to(cache.v.dtype))
        k_full, v_full = cache.k.to(cd), cache.v.to(cd)
    out = _sdpa(q, k_full, v_full, q_pos, cache.pos, causal=True,
                window=window, softcap=cfg.attn_softcap, compute_dtype=cd)
    return out @ p["wo"].to(cd), cache


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------


def init_mlp(gen, d: int, d_ff: int, kind: str, dtype, lead: tuple = ()):
    p = {"w_up": init_normal(gen, lead + (d, d_ff), 1.0 / math.sqrt(d), dtype),
         "w_down": init_normal(gen, lead + (d_ff, d), 1.0 / math.sqrt(d_ff),
                           dtype)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = init_normal(gen, lead + (d, d_ff), 1.0 / math.sqrt(d),
                              dtype)
    return p


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` step by step, each step
    rounded to x's dtype and the constants in x's dtype, as the
    reference's lowering computes it.  In bf16 ``F.gelu`` rounds once, and
    its error and the reference's add up; in float32 the two agree to
    rounding."""
    c = torch.tensor(0.044715, dtype=x.dtype)
    k = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(k * (x + c * (x * x * x))))
    return x * cdf


def mlp(p, x, kind: str) -> torch.Tensor:
    cd = x.dtype
    up = x @ p["w_up"].to(cd)
    if kind == "swiglu":
        up = F.silu(x @ p["w_gate"].to(cd)) * up
    elif kind == "geglu":
        up = F.gelu(x @ p["w_gate"].to(cd), approximate="tanh") * up
    elif kind == "gelu":                    # whisper, the only "gelu" MLP
        up = gelu_tanh(up)
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    return up @ p["w_down"].to(cd)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _gold_logits(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(logits, -1, idx)``.  On a DTensor each device gathers
    from its own slice of the vocabulary under ``local_map`` (an index
    outside the slice gives 0) and the slices' results are a partial sum:
    DTensor's own gather backward scatters into a zero tensor of the whole
    unsplit logits on every device."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, idx)
    mesh, vdim = logits.device_mesh, logits.ndim - 1
    rows = tuple(p if p == Shard(0) else Replicate() for p in logits.placements)
    split = tuple(p if p in (Shard(0), Shard(vdim)) else Replicate()
                  for p in logits.placements)
    out = tuple(Partial() if p == Shard(vdim) else p for p in split)
    block = 0
    for d, p in enumerate(split):               # major to minor
        if p == Shard(vdim):
            block = block * mesh.shape[d] + mesh.get_local_rank(d)

    def local(lg, ix):
        n = lg.shape[-1]
        ix = ix - block * n
        mine = (ix >= 0) & (ix < n)
        g = torch.gather(lg, -1, ix.clamp(0, n - 1))
        return torch.where(mine, g, torch.zeros_like(g))

    return local_map(local, out_placements=(out,), in_placements=(split, rows),
                     device_mesh=mesh, redistribute_inputs=True)(logits, idx)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE; logits [B,S,V] (any dtype, upcast), labels [B,S]."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        # a vocab-split slab: the max and the sum of exponentials each
        # reduce across the split (DTensor's logsumexp gathers the whole
        # vocabulary on every device)
        m = shard_hint(logits.amax(dim=-1, keepdim=True).detach(),
                       BATCH_AXES)
        logz = (m + torch.log(torch.exp(logits - m).sum(
            dim=-1, keepdim=True)))[..., 0]
    else:
        logz = torch.logsumexp(logits, dim=-1)
    # the gold logit keeps its trailing dim until the subtraction: on a
    # vocab-split DTensor it is a partial sum over the split
    gold = _gold_logits(logits, labels.unsqueeze(-1).long())
    nll = (logz.unsqueeze(-1) - gold)[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
