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

One card has no mesh, so the reference's ``shard_hint`` is the identity
and is left out.  Windows are Python ints here (the port runs its layer
stack as a Python loop), so the K5 branch of ``attention`` is live for
every layer.  ``bf16_grad_barrier`` is the reference's identity whose
backward casts the cotangent to bfloat16 (no model calls it, as in the
reference).

Params are drawn from a ``torch.Generator`` (:func:`generator`); on the
``meta`` device, which has none, the init functions draw nothing and
return shape-only tensors.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig


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
    unlimited."""
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


def _sdpa_q_chunked(q, k, v, q_pos, k_pos, *, causal, window, softcap,
                    compute_dtype, q_chunk):
    """The [Sq, Skv] score matrix one query chunk at a time ([q_chunk, Skv]
    slabs); numerically identical to :func:`_sdpa`.  Inference only, so a
    plain loop (the reference scans with remat for the backward)."""
    outs = [_sdpa(q[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk], k_pos,
                  causal=causal, window=window, softcap=softcap,
                  compute_dtype=compute_dtype)
            for i in range(0, q.shape[1], q_chunk)]
    return torch.cat(outs, dim=1)


def _sdpa_auto(q, k, v, q_pos, k_pos, *, causal, window, softcap,
               compute_dtype, q_chunk):
    Sq = q.shape[1]
    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        return _sdpa_q_chunked(q, k, v, q_pos, k_pos, causal=causal,
                               window=window, softcap=softcap,
                               compute_dtype=compute_dtype, q_chunk=q_chunk)
    return _sdpa(q, k, v, q_pos, k_pos, causal=causal, window=window,
                 softcap=softcap, compute_dtype=compute_dtype)


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
                         q_chunk=cfg.q_chunk)
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
                         q_chunk=cfg.q_chunk)
        return out @ p["wo"].to(cd), None

    # decode: write S new token(s) into slots q_pos % Smax, attend over cache
    smax = cache.k.shape[1]
    slots = q_pos % smax                                       # [B,S]
    bidx = torch.arange(B, device=x.device)[:, None]
    cache.pos[bidx, slots] = q_pos.to(torch.int32)
    if cache.quantized:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache.k[bidx, slots] = kq
        cache.v[bidx, slots] = vq
        cache.k_scale[bidx, slots] = ks
        cache.v_scale[bidx, slots] = vs
        k_full = _dequantize_kv(cache.k, cache.k_scale, cd)
        v_full = _dequantize_kv(cache.v, cache.v_scale, cd)
    else:
        cache.k[bidx, slots] = k.to(cache.k.dtype)
        cache.v[bidx, slots] = v.to(cache.v.dtype)
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


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE; logits [B,S,V] (any dtype, upcast), labels [B,S]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
