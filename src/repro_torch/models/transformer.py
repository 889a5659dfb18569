"""The dense transformer family (llama3 / gemma2 / chatglm3, internvl2's
backbone) on torch tensors.

The port of the dense half of ``repro/models/transformer.py``.
``build_dense`` returns the same functional API as the reference:

  init(seed)                           -> params dict
  loss_fn(params, batch)               -> (loss, metrics)
  prefill(params, batch)               -> logits
  init_cache(batch, max_slots)         -> decode cache
  decode_step(params, cache, tok, pos) -> (logits, cache)

Parameters keep the reference's names and its stacked layout: every leaf
under ``"layers"`` carries a leading ``[L]`` dim.  The reference scans
over that dim; the port runs a Python loop over it, so each layer's window
is a Python int.  ``build_moe``, ``build_hybrid`` and ``build_audio`` wait
for later slices.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (KVCache, attention, dtype_of,
                                       init_attn, init_embedding,
                                       init_kv_cache, init_mlp, init_normal,
                                       init_rms_norm, mlp, rms_norm,
                                       softmax_cross_entropy)

# ---------------------------------------------------------------------------
# per-layer window schedule
# ---------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig) -> list[int]:
    """windows[L]: 0 = full/global attention, >0 = sliding window."""
    L = cfg.n_layers
    if cfg.layer_pattern == "local_global" and cfg.window:
        return [cfg.window if (i % 2 == 0) else 0 for i in range(L)]
    if cfg.family == "hybrid" and cfg.window:
        # Hymba: global attention at first, middle and last layer only.
        glob = {0, L // 2, L - 1}
        return [0 if i in glob else cfg.window for i in range(L)]
    return [cfg.window] * L


# ---------------------------------------------------------------------------
# decoder block (dense)
# ---------------------------------------------------------------------------


def init_block(gen, cfg: ModelConfig, dtype, lead: tuple = ()):
    """A dense block's params, each leaf with leading dims ``lead`` (the
    moe, hybrid and cross kinds wait for their families)."""
    dev = gen.device
    return {
        "ln1": init_rms_norm(cfg.d_model, dtype, dev, lead),
        "attn": init_attn(gen, cfg, dtype, lead),
        "ln2": init_rms_norm(cfg.d_model, dtype, dev, lead),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, lead),
    }


def block_apply(cfg: ModelConfig, p, x, q_pos, window: int, *,
                cache: KVCache | None = None, causal: bool = True):
    """Pre-norm attention + MLP with residuals.  Returns (x, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps, cfg.norm_cast_early)
    attn_out, new_cache = attention(
        cfg, p["attn"], h, q_pos, window=window, cache=cache,
        rope=cfg.rope != "none", causal=causal)
    x = x + attn_out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps, cfg.norm_cast_early)
    return x + mlp(p["mlp"], h2, cfg.mlp), new_cache


# ---------------------------------------------------------------------------
# stack runners (a loop over layers)
# ---------------------------------------------------------------------------


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked params dict (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def run_stack(cfg: ModelConfig, stacked, x, q_pos, windows, *,
              causal: bool = True):
    """Train/prefill pass over the L stacked layers."""
    for i, w in enumerate(windows):
        x, _ = block_apply(cfg, _layer(stacked, i), x, q_pos, w,
                           causal=causal)
    return x


def run_stack_decode(cfg: ModelConfig, stacked, x, q_pos, windows,
                     caches: KVCache):
    """One-token decode across the L stacked layers; writes each layer's
    slice of the stacked cache in place.  Returns (x, caches)."""
    for i, w in enumerate(windows):
        x, _ = block_apply(cfg, _layer(stacked, i), x, q_pos, w,
                           cache=caches.layer(i))
    return x, caches


# ---------------------------------------------------------------------------
# shared model scaffolding
# ---------------------------------------------------------------------------


def _embed_in(params, cfg, tokens):
    cd = dtype_of(cfg.compute_dtype)
    # F.embedding, not indexing: its backward sums each row's gradients in
    # a fixed order (indexing's accumulating backward does not on the CPU)
    x = F.embedding(tokens, params["embed"]).to(cd)
    if cfg.name.startswith("gemma2"):                   # gemma2 embeds scaled
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32
                             ).to(cd)
    return x


def _padded_vocab(cfg) -> int:
    return -(-cfg.vocab // 256) * 256


def _unembed(params, cfg, x):
    """Project to the (padded) vocabulary: [..., Vp] with the padded tail
    pinned to -1e30 (invisible to softmax/argmax); callers on the public
    API slice back to cfg.vocab via _public_logits."""
    cd = x.dtype
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    table = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    V, Vp = cfg.vocab, _padded_vocab(cfg)
    if Vp != V:
        table = F.pad(table, (0, Vp - V))
    logits = x @ table.to(cd)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(
            logits.float() / cfg.final_softcap)
    if Vp != V:
        logits[..., V:] = -1e30
    return logits


def _public_logits(cfg, logits):
    return logits[..., : cfg.vocab] if _padded_vocab(cfg) != cfg.vocab \
        else logits


def _init_common(gen, cfg: ModelConfig, dtype):
    p = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model, dtype),
         "ln_f": init_rms_norm(cfg.d_model, dtype, gen.device)}
    if not cfg.tie_embeddings:
        p["unembed"] = init_normal(gen, (cfg.d_model, cfg.vocab),
                                   1.0 / math.sqrt(cfg.d_model), dtype)
    return p


def _positions(batch: int, seq: int, device):
    return torch.arange(seq, dtype=torch.int32,
                        device=device).expand(batch, seq)


# ---------------------------------------------------------------------------
# DENSE (gemma2 / chatglm3 / llama3) and VLM (internvl2 backbone)
# ---------------------------------------------------------------------------


def build_dense(cfg: ModelConfig, max_seq: int, device: torch.device):
    """The five model functions of a dense (or vlm) config on ``device``.
    ``max_seq`` is unused: the dense family is length-agnostic."""
    dtype = dtype_of(cfg.param_dtype)
    windows = layer_windows(cfg)
    is_vlm = cfg.family == "vlm"

    def init(seed: int):
        """Random params from a torch.Generator on ``device`` seeded with
        ``seed``, at the reference's scales (not its bits)."""
        gen = torch.Generator(device=device).manual_seed(seed)
        p = _init_common(gen, cfg, dtype)
        p["layers"] = init_block(gen, cfg, dtype, lead=(cfg.n_layers,))
        if is_vlm:
            p["projector"] = init_normal(gen, (cfg.d_model, cfg.d_model),
                                         1.0 / math.sqrt(cfg.d_model), dtype)
        return p

    def _forward(params, batch):
        x = _embed_in(params, cfg, batch["tokens"])
        if is_vlm:
            cd = x.dtype
            patches = batch["patches"].to(cd) @ params["projector"].to(cd)
            x = torch.cat([patches, x], dim=1)
        q_pos = _positions(x.shape[0], x.shape[1], x.device)
        x = run_stack(cfg, params["layers"], x, q_pos, windows)
        return _unembed(params, cfg, x)

    def loss_fn(params, batch):
        logits = _forward(params, batch)
        tokens = batch["tokens"]
        n_txt = tokens.shape[1]
        logits = logits[:, -n_txt:-1] if not is_vlm \
            else logits[:, -n_txt - 1:-1]
        labels = tokens[:, 1:] if not is_vlm else tokens
        loss = softmax_cross_entropy(logits, labels)
        return loss, {"loss": loss, "aux": torch.zeros_like(loss)}

    def prefill(params, batch):
        return _public_logits(cfg, _forward(params, batch))

    def init_cache(batch_size: int, max_slots: int):
        cd = dtype_of(cfg.kv_cache_dtype or cfg.compute_dtype)
        return {"kv": init_kv_cache(batch_size, max_slots, cfg.n_kv_heads,
                                    cfg.head_dim, cd, device,
                                    lead=(cfg.n_layers,))}

    def decode_step(params, cache, tok, pos):
        x = _embed_in(params, cfg, tok[:, None])
        q_pos = pos[:, None].to(torch.int32)
        x, new_kv = run_stack_decode(cfg, params["layers"], x, q_pos, windows,
                                     cache["kv"])
        logits = _public_logits(cfg, _unembed(params, cfg, x))
        return logits[:, 0], {"kv": new_kv}

    return init, loss_fn, prefill, init_cache, decode_step
