"""The port's audio family (whisper-tiny: an encoder over frame embeddings
and a cross-attending decoder) against the JAX reference, on the CPU.

Reduced configs (2 encoder and 2 decoder layers, float32 compute) are
built by both packages; the reference's params cross over through
``params_from_reference`` and numpy-seeded tokens and frames go through
both, within rtol/atol 2e-4:

  * ``sinusoidal_positions``, the cross-attention branch of ``attention``
    and ``encode`` alone;
  * ``prefill`` with the K5 branch off and on: K5 runs once per encoder
    layer (non-causal) and once per decoder self-attention (causal), never
    for cross-attention; ``decode_step`` with the encoder output pinned
    into the cache against the reference's and against the port's prefill,
    ``loss_fn``;
  * in bf16 compute, the prefill no farther from the reference's bf16
    prefill than that is from the reference's float32 one (mean distance,
    and largest distance up to one bf16 ulp: see
    ``_torch_families.assert_within_bf16_distance``);
  * the serve loop's greedy tokens equal to the reference loop's, and the
    serve CLI on the CPU with seeded frames.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (TOL, Built, assert_within_bf16_distance, batch,
                             bf16_prefills, count_flash, decode_both,
                             ref_serve_loop)
from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.models import layers

ARCH = "whisper-tiny"


@pytest.fixture(scope="module")
def built():
    return Built()


@pytest.fixture
def flash_calls(monkeypatch):
    return count_flash(monkeypatch)


@pytest.mark.parametrize("seq,d", [(16, 256), (1500, 384), (7, 2)])
def test_sinusoidal_positions_match_reference(seq, d):
    """Within 2e-4: XLA's and torch's float32 exp differ in the last bit
    of some frequencies, and at 1500 frames a float32 angle's own ulp is
    1.2e-4."""
    want = np.asarray(ref_layers.sinusoidal_positions(seq, d))
    got = layers.sinusoidal_positions(seq, d)
    assert got.shape == (seq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("Sq,Skv", [(1, 16), (24, 40), (600, 130)])
def test_cross_attention_matches_reference(monkeypatch, flash_calls, Sq,
                                           Skv):
    """Queries from x, keys and values from enc_out: no mask, no rope, no
    cache, and never K5 (even with the kernel branch on and Sq >= 128);
    Sq 600 takes the query-chunked path in both packages."""
    rcfg = dataclasses.replace(ref_get_config(ARCH).reduced(), q_chunk=300,
                               use_flash_kernel=True)
    cfg = dataclasses.replace(configs.get_config(ARCH).reduced(),
                              q_chunk=300, use_flash_kernel=True)
    rp = ref_layers.init_attn(jax.random.PRNGKey(1), rcfg, jnp.float32)
    pp = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    rng = np.random.default_rng(Sq)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, Skv, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (2, Sq))
    want, _ = ref_layers.attention(rcfg, rp, jnp.asarray(x), jnp.asarray(pos),
                                   enc_out=jnp.asarray(enc), rope=False)
    got, cache = layers.attention(cfg, pp, torch.tensor(x),
                                  torch.tensor(pos), enc_out=torch.tensor(enc),
                                  rope=False)
    assert cache is None and flash_calls == []
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_attn_head_counts():
    cfg = configs.get_config(ARCH).reduced()
    gen = layers.generator(torch.device("cpu"), 0)
    p = layers.init_attn(gen, cfg, torch.float32, n_heads=4, n_kv=1)
    hd = cfg.head_dim
    assert p["wq"].shape == (cfg.d_model, 4 * hd)
    assert p["wk"].shape == p["wv"].shape == (cfg.d_model, hd)
    assert p["wo"].shape == (4 * hd, cfg.d_model)


@pytest.mark.parametrize("frames", [16, 130])
def test_encode_matches_reference(built, frames):
    ref, rparams, port, params = built(ARCH)
    rb, pb = batch(port.config, 2, 8, frames=frames)
    want = np.asarray(jax.jit(ref.encode)(rparams, rb["frames"]))
    got = port.encode(params, pb["frames"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_matches_reference(built, flash_calls, flash):
    ref, rparams, port, params = built(ARCH, use_flash_kernel=flash)
    rb, pb = batch(port.config, 2, 128, frames=150)
    want = np.asarray(jax.jit(ref.prefill)(rparams, rb), np.float32)
    got = port.prefill(params, pb)
    assert got.shape == (2, 128, port.config.vocab)
    cfg = port.config
    assert flash_calls == ([(False, 0)] * cfg.n_enc_layers
                           + [(True, 0)] * cfg.n_layers if flash else [])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_matches_reference_and_prefill(built):
    ref, rparams, port, params = built(ARCH)
    rb, pb = batch(port.config, 2, 8)
    toks = np.asarray(rb["tokens"])
    frames = np.asarray(rb["frames"])
    want, got = decode_both(ref, rparams, port, params, toks, slots=16,
                            frames=frames)
    np.testing.assert_allclose(got, want, **TOL)
    full = port.prefill(params, pb).numpy()
    np.testing.assert_allclose(got, full, **TOL)


def test_loss_matches_reference(built):
    ref, rparams, port, params = built(ARCH)
    rb, pb = batch(port.config, 2, 64)
    want, wm = jax.jit(ref.loss_fn)(rparams, rb)
    got, metrics = port.loss_fn(params, pb)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(metrics["aux"]) == float(wm["aux"]) == 0.0


@pytest.mark.parametrize("flash", [False, True])
def test_bf16_prefill_within_the_reference_bf16_distance(built, flash):
    assert_within_bf16_distance(*bf16_prefills(built, ARCH, flash, 2, 130))


def test_serve_loop_tokens_equal_reference(built):
    ref, rparams, port, params = built(ARCH)
    rng = np.random.default_rng(0)
    cfg = port.config
    prompt = rng.integers(0, cfg.vocab, (4, 16))
    frames = rng.standard_normal((4, cfg.enc_frames, cfg.d_model)
                                 ).astype(np.float32)
    want = ref_serve_loop(ref, rparams, prompt, gen=8, frames=frames)
    res = serve.serve_loop(port, params,
                           torch.tensor(prompt, dtype=torch.int32), 8,
                           frames=torch.tensor(frames))
    np.testing.assert_array_equal(res["tokens"].numpy(), want)


def test_serve_cli_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--gen", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}: batch 4, prompt 16, generated 4" in out
    assert res["tokens"].shape == (4, 4)
    assert bool(torch.isfinite(res["logits"]).all())
