"""Shared cases of the moe, hybrid and audio family tests (not a test
module): both packages build the same reduced config, the reference's
params cross over with ``params_from_reference``, and numpy-seeded inputs
go through both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.dist.steps import make_serve_step as ref_make_serve_step
from repro.models import build_model as ref_build_model
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import build_model
from repro_torch.models import layers as port_layers

TOL = dict(rtol=2e-4, atol=2e-4)


class Built:
    """(ref model, ref params, port model, port params) per (arch, knobs),
    built once per instance."""

    def __init__(self, max_seq: int = 256):
        self.max_seq = max_seq
        self.memo = {}

    def __call__(self, arch, **knobs):
        key = (arch, tuple(sorted(knobs.items())))
        if key not in self.memo:
            rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                       **knobs)
            cfg = dataclasses.replace(configs.get_config(arch).reduced(),
                                      **knobs)
            ref = ref_build_model(rcfg, max_seq=self.max_seq)
            rparams = ref.init(jax.random.PRNGKey(0))
            tree = jax.tree.map(np.asarray, rparams)
            self.memo[key] = (ref, rparams,
                              build_model(cfg, self.max_seq, device="cpu"),
                              params_from_reference(tree, cfg, "cpu"))
        return self.memo[key]


def batch(cfg, B, S, seed=1, frames=0):
    """Tokens [B, S] (and, for audio, ``frames`` [B, frames, d] frame
    embeddings) for both packages."""
    rng = np.random.default_rng(seed)
    np_batch = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "audio":
        np_batch["frames"] = rng.standard_normal(
            (B, frames or cfg.enc_frames, cfg.d_model)).astype(np.float32)
    ref = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
           for k, v in np_batch.items()}
    port = {k: torch.tensor(v, dtype=torch.int32 if k == "tokens"
                            else torch.float32) for k, v in np_batch.items()}
    return ref, port


def count_flash(monkeypatch) -> list:
    """Records (causal, window) of each model call of the K5 entry point."""
    calls = []
    real = port_layers.kops.flash_attention

    def counted(*args, **kw):
        calls.append((kw.get("causal", True), kw.get("window", 0)))
        return real(*args, **kw)

    monkeypatch.setattr(port_layers.kops, "flash_attention", counted)
    return calls


def decode_both(ref, rparams, port, params, toks, slots, frames=None):
    """Both decode paths over toks [B, n] (audio: the encoder output of
    ``frames`` pinned into each cache first); returns (ref, port) logits
    [B, n, V]."""
    B, n = toks.shape
    rcache, cache = ref.init_cache(B, slots), port.init_cache(B, slots)
    if frames is not None:
        rcache["enc_out"] = jax.jit(ref.encode)(rparams,
                                                jnp.asarray(frames))
        cache["enc_out"] = port.encode(params, torch.tensor(frames))
    step = jax.jit(ref.decode_step)
    rl, pl = [], []
    for pos in range(n):
        lg, rcache = step(rparams, rcache, jnp.asarray(toks[:, pos],
                                                       jnp.int32),
                          jnp.full((B,), pos, jnp.int32))
        plg, cache = port.decode_step(
            params, cache, torch.tensor(toks[:, pos], dtype=torch.int32),
            torch.full((B,), pos, dtype=torch.int32))
        rl.append(np.asarray(lg, np.float32))
        pl.append(plg.numpy())
    return np.stack(rl, 1), np.stack(pl, 1)


def ref_serve_loop(ref, rparams, prompt, gen, frames=None):
    """The loop of ``repro.launch.serve.main``: the encoder's output
    pinned into the cache (audio), the prompt stepped through the cache,
    then greedy decode."""
    B, P = prompt.shape
    step = jax.jit(ref_make_serve_step(ref))
    cache = ref.init_cache(B, P + gen)
    if frames is not None:
        cache["enc_out"] = jax.jit(ref.encode)(rparams, jnp.asarray(frames))
    prompt = jnp.asarray(prompt, jnp.int32)
    for pos in range(P - 1):
        _, _, cache = step(rparams, cache, prompt[:, pos],
                           jnp.full((B,), pos, jnp.int32))
    tok, out = prompt[:, -1], []
    for i in range(gen):
        tok, _, cache = step(rparams, cache, tok,
                             jnp.full((B,), P - 1 + i, jnp.int32))
        out.append(np.asarray(tok))
    return np.stack(out, 1)


def bf16_prefills(built, arch, flash, B, S, **knobs):
    """The port's bf16 prefill, the reference's bf16 prefill and the
    reference's float32 prefill of the same params and inputs, as float32
    numpy logits."""
    ref16, rparams, port, params = built(arch, compute_dtype="bfloat16",
                                         use_flash_kernel=flash, **knobs)
    ref32 = built(arch, **knobs)[0]
    rb, pb = batch(port.config, B, S, frames=S)
    want = np.asarray(jax.jit(ref16.prefill)(rparams, rb), np.float32)
    f32 = np.asarray(jax.jit(ref32.prefill)(rparams, rb), np.float32)
    return port.prefill(params, pb).float().numpy(), want, f32


def assert_within_bf16_distance(got, want, f32, rows=None):
    """The port's bf16 logits ``got`` are no farther from the reference's
    bf16 logits ``want`` than those are from the reference's float32
    logits ``f32`` (over the token ``rows`` given, a boolean [B, S] mask):
    in mean absolute distance, and in largest distance up to one bf16 ulp
    of the largest logit.  Both packages round each logit to bf16 last,
    from float32 sums in their own orders, so a logit near a rounding
    boundary rounds one ulp apart; a bf16 path that rounds elsewhere, or
    accumulates in bf16, misses by far more."""
    if rows is not None:
        got, want, f32 = got[rows], want[rows], f32[rows]
    assert np.isfinite(got).all()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(f32).max())) - 7)
    assert np.abs(got - want).mean() <= np.abs(want - f32).mean()
    assert np.abs(got - want).max() <= np.abs(want - f32).max() + ulp
