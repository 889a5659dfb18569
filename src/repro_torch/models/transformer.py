"""The transformer families on torch tensors: dense (llama3 / gemma2 /
chatglm3, internvl2's backbone), moe (deepseek-moe-16b / kimi-k2),
hybrid (hymba: attention and Mamba heads in parallel) and audio (whisper:
an encoder over stub frame embeddings and a cross-attending decoder).

The port of ``repro/models/transformer.py``.  Every builder returns the
same functional API as the reference:

  init(seed)                           -> params dict
  loss_fn(params, batch)               -> (loss, metrics)
  prefill(params, batch)               -> logits
  init_cache(batch, max_slots)         -> decode cache
  decode_step(params, cache, tok, pos) -> (logits, cache)

Parameters keep the reference's names and its stacked layout: every leaf
under ``"layers"`` carries a leading ``[L]`` dim.  The reference scans
over that dim; the port runs a Python loop over it, so each layer's window
is a Python int.  ``cfg.remat`` checkpoints each layer of a train pass, as
the reference's ``jax.checkpoint`` does.  ``build_audio`` also returns ``encode(params, frames)``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.utils.checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (BATCH_AXES, KVCache, attention,
                                       dtype_of, embed, generator,
                                       init_attn, init_embedding,
                                       init_kv_cache, init_mlp, init_normal,
                                       init_rms_norm, mlp, rms_norm,
                                       shard_hint, sinusoidal_positions,
                                       softmax_cross_entropy, zero_pad)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.ssm import (init_mamba, init_mamba_state, mamba_seq,
                                    mamba_step)

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
# decoder block (dense / moe / hybrid / cross)
# ---------------------------------------------------------------------------


def init_block(gen, cfg: ModelConfig, dtype, *, kind: str = "dense",
               d_ff: int = 0, lead: tuple = ()):
    """A block's params, each leaf with leading dims ``lead``.  kind:
    dense | moe | hybrid | cross (audio decoder)."""
    dev = gen.device
    p = {
        "ln1": init_rms_norm(cfg.d_model, dtype, dev, lead),
        "attn": init_attn(gen, cfg, dtype, lead),
        "ln2": init_rms_norm(cfg.d_model, dtype, dev, lead),
    }
    if kind == "moe":
        p["moe"] = init_moe(gen, cfg, dtype, lead)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, d_ff or cfg.d_ff, cfg.mlp,
                            dtype, lead)
    if kind == "hybrid":
        p["mamba"] = init_mamba(gen, cfg, dtype, lead)
    if kind == "cross":
        p["ln_x"] = init_rms_norm(cfg.d_model, dtype, dev, lead)
        p["xattn"] = init_attn(gen, cfg, dtype, lead)
    return p


def block_apply(cfg: ModelConfig, p, x, q_pos, window: int, *,
                kind: str = "dense", cache: KVCache | None = None,
                ssm_state=None, enc_out=None, causal: bool = True):
    """Pre-norm attention (with Hymba's parallel Mamba head, or whisper's
    cross-attention) + MLP or MoE, with residuals.  Returns (x, cache,
    ssm_state, aux): ``aux`` is the MoE's float32 loss, None for the other
    kinds."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps, cfg.norm_cast_early)
    attn_out, new_cache = attention(
        cfg, p["attn"], h, q_pos, window=window, cache=cache,
        rope=cfg.rope != "none", causal=causal)
    new_ssm = None
    if kind == "hybrid":
        if ssm_state is None:
            m_out = mamba_seq(cfg, p["mamba"], h)
        else:
            m_out, new_ssm = mamba_step(cfg, p["mamba"], ssm_state, h[:, 0])
            m_out = m_out[:, None, :]
        attn_out = 0.5 * (attn_out + m_out)          # Hymba parallel fusion
    x = x + attn_out
    if kind == "cross":
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps, cfg.norm_cast_early)
        x_out, _ = attention(cfg, p["xattn"], hx, q_pos, enc_out=enc_out,
                             rope=False)
        x = x + x_out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps, cfg.norm_cast_early)
    if kind == "moe":
        ff, aux = moe_apply(cfg, p["moe"], h2)
    else:
        ff, aux = mlp(p["mlp"], h2, cfg.mlp), None
    return x + ff, new_cache, new_ssm, aux


# ---------------------------------------------------------------------------
# stack runners (a loop over layers)
# ---------------------------------------------------------------------------


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked params dict (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def maybe_remat(fn, cfg: ModelConfig, x: torch.Tensor):
    """``fn`` under activation checkpointing when ``cfg.remat`` and
    autograd records x (the reference's ``jax.checkpoint`` of each scanned
    layer): the backward recomputes the layer from its input instead of
    keeping its activations.  Bitwise the same gradients."""
    if not (cfg.remat and torch.is_grad_enabled() and x.requires_grad):
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def run_stack(cfg: ModelConfig, stacked, x, q_pos, windows, *,
              kind: str = "dense", enc_out=None, causal: bool = True):
    """Train/prefill pass over the L stacked layers.  Returns (x, aux):
    the layers' aux losses summed in float32 in layer order."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = maybe_remat(block_apply, cfg, x)
    for i, w in enumerate(windows):
        x, _, _, a = block(cfg, _layer(stacked, i), x, q_pos, w,
                           kind=kind, enc_out=enc_out, causal=causal)
        if a is not None:
            aux = aux + a
    return x, aux


def run_stack_decode(cfg: ModelConfig, stacked, x, q_pos, windows,
                     caches: KVCache, *, kind: str = "dense",
                     ssm_states=None, enc_out=None):
    """One-token decode across the L stacked layers; writes each layer's
    slice of the stacked cache in place.  Returns (x, caches), and for
    the hybrid kind (x, caches, ssm_states) with the new Mamba states
    stacked anew."""
    new_ssm = []
    for i, w in enumerate(windows):
        sstate = None if ssm_states is None else _layer(ssm_states, i)
        x, _, s, _ = block_apply(cfg, _layer(stacked, i), x, q_pos, w,
                                 kind=kind, cache=caches.layer(i),
                                 ssm_state=sstate, enc_out=enc_out)
        new_ssm.append(s)
    if ssm_states is None:
        return x, caches
    return x, caches, {k: torch.stack([s[k] for s in new_ssm])
                       for k in ssm_states}


# ---------------------------------------------------------------------------
# shared model scaffolding
# ---------------------------------------------------------------------------


def _embed_in(params, cfg, tokens):
    cd = dtype_of(cfg.compute_dtype)
    x = embed(params["embed"], tokens).to(cd)
    if cfg.name.startswith("gemma2"):                   # gemma2 embeds scaled
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32
                             ).to(cd)
    return shard_hint(x, BATCH_AXES, None, None)


def _padded_vocab(cfg) -> int:
    return -(-cfg.vocab // 256) * 256


def _unembed(params, cfg, x):
    """Project to the (padded) vocabulary: [..., Vp] with the padded tail
    pinned to -1e30 (invisible to softmax/argmax); callers on the public
    API slice back to cfg.vocab via _public_logits.  Padding to a multiple
    of 256 keeps the logits slab model-axis shardable for the odd-sized
    vocabs (whisper 51865, internvl 151655)."""
    cd = x.dtype
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    table = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    V, Vp = cfg.vocab, _padded_vocab(cfg)
    if Vp != V:
        table = zero_pad(table, (0, Vp - V))
    logits = x @ table.to(cd)
    # keep the [B, S, V] slab batch- AND vocab-sharded on a mesh: at
    # 128k-256k vocabs an unsharded logits tensor alone would overflow HBM
    logits = shard_hint(logits, BATCH_AXES, None, "model")
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(
            logits.float() / cfg.final_softcap)
    if Vp != V:
        logits.masked_fill_(torch.arange(Vp, device=logits.device) >= V,
                            -1e30)
    return shard_hint(logits, BATCH_AXES, None, "model")


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


def _kv_caches(cfg: ModelConfig, batch_size: int, max_slots: int, n: int,
               device) -> KVCache:
    cd = dtype_of(cfg.kv_cache_dtype or cfg.compute_dtype)
    return init_kv_cache(batch_size, max_slots, cfg.n_kv_heads, cfg.head_dim,
                         cd, device, lead=(n,))


def _lm_loss(logits, tokens, aux):
    loss = softmax_cross_entropy(logits[:, :-1], tokens[:, 1:]) + aux
    return loss, {"loss": loss, "aux": aux}


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
        gen = generator(device, seed)
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
        x, _ = run_stack(cfg, params["layers"], x, q_pos, windows)
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
        return {"kv": _kv_caches(cfg, batch_size, max_slots, cfg.n_layers,
                                 device)}

    def decode_step(params, cache, tok, pos):
        x = _embed_in(params, cfg, tok[:, None])
        q_pos = pos[:, None].to(torch.int32)
        x, new_kv = run_stack_decode(cfg, params["layers"], x, q_pos, windows,
                                     cache["kv"])
        logits = _public_logits(cfg, _unembed(params, cfg, x))
        return logits[:, 0], {"kv": new_kv}

    return init, loss_fn, prefill, init_cache, decode_step


# ---------------------------------------------------------------------------
# MOE (deepseek-moe-16b / kimi-k2): leading dense layer(s) + the MoE stack
# ---------------------------------------------------------------------------


def build_moe(cfg: ModelConfig, max_seq: int, device: torch.device):
    """The five model functions of a moe config on ``device``: the
    ``n_dense_layers`` leading dense blocks (FFN width ``dense_d_ff``,
    params under ``"dense_layers"``) and the MoE blocks (``"layers"``).
    ``max_seq`` is unused."""
    dtype = dtype_of(cfg.param_dtype)
    n_dense = cfg.n_dense_layers
    n_moe = cfg.n_layers - n_dense
    windows = layer_windows(cfg)[n_dense:]

    def init(seed: int):
        """Random params from a torch.Generator on ``device`` seeded with
        ``seed``, at the reference's scales (not its bits)."""
        gen = generator(device, seed)
        p = _init_common(gen, cfg, dtype)
        if n_dense:
            p["dense_layers"] = init_block(gen, cfg, dtype,
                                           d_ff=cfg.dense_d_ff,
                                           lead=(n_dense,))
        p["layers"] = init_block(gen, cfg, dtype, kind="moe", lead=(n_moe,))
        return p

    def _forward(params, batch):
        tokens = batch["tokens"]
        x = _embed_in(params, cfg, tokens)
        q_pos = _positions(*tokens.shape, x.device)
        aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
        if n_dense:
            x, aux0 = run_stack(cfg, params["dense_layers"], x, q_pos,
                                [0] * n_dense)
        x, aux = run_stack(cfg, params["layers"], x, q_pos, windows,
                           kind="moe")
        return _unembed(params, cfg, x), aux0 + aux

    def loss_fn(params, batch):
        logits, aux = _forward(params, batch)
        return _lm_loss(logits, batch["tokens"], aux)

    def prefill(params, batch):
        return _public_logits(cfg, _forward(params, batch)[0])

    def init_cache(batch_size: int, max_slots: int):
        cache = {"kv": _kv_caches(cfg, batch_size, max_slots, n_moe, device)}
        if n_dense:
            cache["kv_dense"] = _kv_caches(cfg, batch_size, max_slots,
                                           n_dense, device)
        return cache

    def decode_step(params, cache, tok, pos):
        x = _embed_in(params, cfg, tok[:, None])
        q_pos = pos[:, None].to(torch.int32)
        new_cache = dict(cache)
        if n_dense:
            x, new_cache["kv_dense"] = run_stack_decode(
                cfg, params["dense_layers"], x, q_pos, [0] * n_dense,
                cache["kv_dense"])
        x, new_cache["kv"] = run_stack_decode(cfg, params["layers"], x, q_pos,
                                              windows, cache["kv"],
                                              kind="moe")
        logits = _public_logits(cfg, _unembed(params, cfg, x))
        return logits[:, 0], new_cache

    return init, loss_fn, prefill, init_cache, decode_step


# ---------------------------------------------------------------------------
# HYBRID (hymba: parallel attention + mamba heads)
# ---------------------------------------------------------------------------


def build_hybrid(cfg: ModelConfig, max_seq: int, device: torch.device):
    """The five model functions of a hybrid config on ``device``; the
    decode cache carries each layer's Mamba state (``"ssm"``) beside its
    KV cache.  ``max_seq`` is unused."""
    dtype = dtype_of(cfg.param_dtype)
    windows = layer_windows(cfg)

    def init(seed: int):
        """Random params from a torch.Generator on ``device`` seeded with
        ``seed``, at the reference's scales (not its bits)."""
        gen = generator(device, seed)
        p = _init_common(gen, cfg, dtype)
        p["layers"] = init_block(gen, cfg, dtype, kind="hybrid",
                                 lead=(cfg.n_layers,))
        return p

    def _forward(params, batch):
        tokens = batch["tokens"]
        x = _embed_in(params, cfg, tokens)
        q_pos = _positions(*tokens.shape, x.device)
        x, aux = run_stack(cfg, params["layers"], x, q_pos, windows,
                           kind="hybrid")
        return _unembed(params, cfg, x), aux

    def loss_fn(params, batch):
        logits, aux = _forward(params, batch)
        return _lm_loss(logits, batch["tokens"], aux)

    def prefill(params, batch):
        return _public_logits(cfg, _forward(params, batch)[0])

    def init_cache(batch_size: int, max_slots: int):
        cd = dtype_of(cfg.kv_cache_dtype or cfg.compute_dtype)
        return {"kv": _kv_caches(cfg, batch_size, max_slots, cfg.n_layers,
                                 device),
                "ssm": init_mamba_state(cfg, batch_size, cd, device,
                                        lead=(cfg.n_layers,))}

    def decode_step(params, cache, tok, pos):
        x = _embed_in(params, cfg, tok[:, None])
        q_pos = pos[:, None].to(torch.int32)
        x, new_kv, new_ssm = run_stack_decode(
            cfg, params["layers"], x, q_pos, windows, cache["kv"],
            kind="hybrid", ssm_states=cache["ssm"])
        logits = _public_logits(cfg, _unembed(params, cfg, x))
        return logits[:, 0], {"kv": new_kv, "ssm": new_ssm}

    return init, loss_fn, prefill, init_cache, decode_step


# ---------------------------------------------------------------------------
# AUDIO (whisper-tiny): stub-frontend encoder + cross-attending decoder
# ---------------------------------------------------------------------------


def build_audio(cfg: ModelConfig, max_seq: int, device: torch.device):
    """The five model functions of an audio config on ``device``, and
    ``encode(params, frames) -> enc_out``.  ``max_seq`` sizes the
    decoder's learned position table."""
    dtype = dtype_of(cfg.param_dtype)
    dec_windows = layer_windows(cfg)

    def init(seed: int):
        """Random params from a torch.Generator on ``device`` seeded with
        ``seed``, at the reference's scales (not its bits)."""
        gen = generator(device, seed)
        p = _init_common(gen, cfg, dtype)
        p["enc_layers"] = init_block(gen, cfg, dtype,
                                     lead=(cfg.n_enc_layers,))
        p["enc_ln_f"] = init_rms_norm(cfg.d_model, dtype, device)
        p["dec_layers"] = init_block(gen, cfg, dtype, kind="cross",
                                     lead=(cfg.n_layers,))
        p["pos_emb"] = init_normal(gen, (max_seq, cfg.d_model), 0.01, dtype)
        return p

    def encode(params, frames):
        """Frame embeddings [B, F, d] -> encoder output [B, F, d]
        (non-causal self-attention, sinusoidal positions)."""
        cd = dtype_of(cfg.compute_dtype)
        x = frames.to(cd)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, cd,
                                     x.device)[None]
        q_pos = _positions(x.shape[0], x.shape[1], x.device)
        x, _ = run_stack(cfg, params["enc_layers"], x, q_pos,
                         [0] * cfg.n_enc_layers, causal=False)
        return rms_norm(x, params["enc_ln_f"], cfg.norm_eps)

    def _decode_seq(params, enc_out, tokens):
        x = _embed_in(params, cfg, tokens)
        S = tokens.shape[1]
        x = x + params["pos_emb"][:S].to(x.dtype)[None]
        q_pos = _positions(*tokens.shape, x.device)
        x, aux = run_stack(cfg, params["dec_layers"], x, q_pos, dec_windows,
                           kind="cross", enc_out=enc_out)
        return _unembed(params, cfg, x), aux

    def loss_fn(params, batch):
        enc_out = encode(params, batch["frames"])
        logits, aux = _decode_seq(params, enc_out, batch["tokens"])
        return _lm_loss(logits, batch["tokens"], aux)

    def prefill(params, batch):
        enc_out = encode(params, batch["frames"])
        return _public_logits(cfg, _decode_seq(params, enc_out,
                                               batch["tokens"])[0])

    def init_cache(batch_size: int, max_slots: int):
        return {"kv": _kv_caches(cfg, batch_size, max_slots, cfg.n_layers,
                                 device),
                "enc_out": torch.zeros(
                    (batch_size, cfg.enc_frames, cfg.d_model),
                    dtype=dtype_of(cfg.compute_dtype), device=device)}

    def decode_step(params, cache, tok, pos):
        x = _embed_in(params, cfg, tok[:, None])
        x = x + embed(params["pos_emb"], pos).to(x.dtype)[:, None, :]
        q_pos = pos[:, None].to(torch.int32)
        x, new_kv = run_stack_decode(cfg, params["dec_layers"], x, q_pos,
                                     dec_windows, cache["kv"], kind="cross",
                                     enc_out=cache["enc_out"])
        logits = _public_logits(cfg, _unembed(params, cfg, x))
        return logits[:, 0], {"kv": new_kv, "enc_out": cache["enc_out"]}

    return init, loss_fn, prefill, init_cache, decode_step, encode
