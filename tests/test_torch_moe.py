"""The port's moe family (deepseek-moe-16b, kimi-k2) against the JAX
reference, on the CPU.

Reduced configs (a dense block then a MoE block, 4 experts, top-2, a
shared expert, float32 compute) are built by both packages; the
reference's params cross over through ``params_from_reference`` and
numpy-seeded inputs go through both, within rtol/atol 2e-4:

  * ``moe_apply`` alone, with the reduced config's no-drop capacity and
    with a capacity that drops tokens, output and Switch aux loss; the
    sort-by-expert dispatch (order, kept pairs, slots) equal to the
    reference's;
  * ``prefill`` with the K5 branch off and on (K5 counted once per
    self-attention layer), ``decode_step`` against the reference's and
    against the port's prefill (no-drop capacity, so decode and prefill
    route the same tokens), ``loss_fn``'s loss and aux;
  * in bf16 compute, the prefill no farther from the reference's bf16
    prefill than that is from the reference's float32 one (mean distance,
    and largest distance up to one bf16 ulp: see
    ``_torch_families.assert_within_bf16_distance``), over the tokens
    that every MoE layer of the three runs routes to the same experts: a
    token whose top-k set flips under bf16 rounding (a near tie of two
    router scores) changes its logits by O(1) in either package, so the
    largest distance would compare flips, not rounding; the flipped share
    is held under 5%;
  * the router pinned to float32 under a bfloat16 ``param_dtype``;
  * the serve loop's greedy tokens equal to the reference loop's, and the
    serve CLI on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (TOL, Built, assert_within_bf16_distance, batch,
                             count_flash, decode_both, ref_serve_loop)
from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models import transformer as ref_transformer
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve
from repro_torch.models import moe

ARCH = "deepseek-moe-16b"


@pytest.fixture(scope="module")
def built():
    return Built()


@pytest.fixture
def flash_calls(monkeypatch):
    return count_flash(monkeypatch)


def _moe_case(capacity_factor, T=64, seed=4):
    rcfg = dataclasses.replace(ref_get_config(ARCH).reduced(),
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(configs.get_config(ARCH).reduced(),
                              capacity_factor=capacity_factor)
    rp = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    pp = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    x = np.random.default_rng(seed).standard_normal(
        (2, T // 2, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, rp, pp, x


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
def test_moe_apply_matches_reference(capacity_factor):
    rcfg, cfg, rp, pp, x = _moe_case(capacity_factor)
    want, want_aux = jax.jit(lambda p, x: ref_moe.moe_apply(rcfg, p, x))(
        rp, jnp.asarray(x))
    got, aux = moe.moe_apply(cfg, pp, torch.tensor(x))
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
def test_dispatch_equals_reference(capacity_factor):
    """The stable sort by expert, each pair's rank within its expert and
    its buffer slot, bit for bit (the reference's own expressions)."""
    _, cfg, _, _, _ = _moe_case(capacity_factor)
    T, k, E = 64, cfg.top_k, cfg.n_experts
    top_i = np.stack([np.random.default_rng(t).permutation(E)[:k]
                      for t in range(T)])
    cap = moe.capacity(cfg, T)
    assert cap == int(max(k, round(T * k / E * capacity_factor)))
    flat_e = jnp.asarray(top_i.reshape(-1))
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    rank = jnp.arange(T * k) - jnp.searchsorted(sorted_e, sorted_e,
                                                side="left")
    keep = rank < cap
    slot = jnp.where(keep, sorted_e * cap + rank, E * cap)
    got = moe.dispatch(torch.tensor(top_i), E, cap)
    for g, w in zip(got, (order, keep, slot)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (not bool(keep.all())) == (capacity_factor < 8.0)


def test_capacity_rounds_half_to_even():
    cfg = dataclasses.replace(configs.get_config(ARCH), n_experts=8,
                              top_k=2, capacity_factor=1.25)
    # T * k / E * cf = 2.5 and 3.5: Python's round goes to 2 and 4
    assert moe.capacity(cfg, 8) == 2
    assert moe.capacity(dataclasses.replace(cfg, capacity_factor=1.75),
                        8) == 4
    assert moe.capacity(dataclasses.replace(cfg, capacity_factor=0.1),
                        8) == 2                       # at least top_k


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_matches_reference(built, flash_calls, flash):
    ref, rparams, port, params = built(ARCH, use_flash_kernel=flash)
    rb, pb = batch(port.config, 2, 128)
    want = np.asarray(jax.jit(ref.prefill)(rparams, rb), np.float32)
    before = launch_counts()
    got = port.prefill(params, pb)
    assert launch_counts() == before         # CPU: plain versions only
    assert got.shape == (2, 128, port.config.vocab)
    assert flash_calls == ([(True, 0)] * port.config.n_layers if flash
                           else [])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_prefill_with_dropping_capacity_matches_reference(built):
    ref, rparams, port, params = built(ARCH, capacity_factor=1.0)
    rb, pb = batch(port.config, 2, 64, seed=5)
    want = np.asarray(jax.jit(ref.prefill)(rparams, rb), np.float32)
    np.testing.assert_allclose(port.prefill(params, pb).numpy(), want, **TOL)


def test_decode_matches_reference_and_prefill(built):
    ref, rparams, port, params = built(ARCH)
    toks = np.random.default_rng(2).integers(0, port.config.vocab, (2, 8))
    want, got = decode_both(ref, rparams, port, params, toks, slots=16)
    np.testing.assert_allclose(got, want, **TOL)
    full = port.prefill(params, {"tokens": torch.tensor(toks)}).numpy()
    np.testing.assert_allclose(got, full, **TOL)


def test_loss_matches_reference(built):
    ref, rparams, port, params = built(ARCH)
    rb, pb = batch(port.config, 2, 64)
    want, wm = jax.jit(ref.loss_fn)(rparams, rb)
    got, metrics = port.loss_fn(params, pb)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(wm["aux"]),
                               **TOL)
    assert float(metrics["aux"]) > 0.0
    assert float(metrics["loss"]) == float(got)


def _ref_routed(monkeypatch, ref, rparams, rb) -> tuple:
    """The reference's prefill logits and each MoE layer's sorted top-k
    expert ids per token ([L_moe, T, k]), sent out of its scan by a
    debug callback."""
    real, routed = ref_transformer.moe_apply, []

    def spy(cfg, p, x):
        xt = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        top_i = jax.lax.top_k(jax.nn.softmax(xt @ p["router"], axis=-1),
                              cfg.top_k)[1]
        jax.debug.callback(lambda t: routed.append(np.sort(t, axis=-1)),
                           top_i, ordered=True)
        return real(cfg, p, x)

    monkeypatch.setattr(ref_transformer, "moe_apply", spy)
    logits = np.asarray(jax.jit(lambda p, b: ref.prefill(p, b))(rparams, rb),
                        np.float32)
    monkeypatch.setattr(ref_transformer, "moe_apply", real)
    return logits, np.stack(routed)


def _port_routed(monkeypatch, port, params, pb) -> tuple:
    real, routed = moe.route, []

    def spy(cfg, p, xt):
        out = real(cfg, p, xt)
        routed.append(out[2].sort(dim=-1).values.numpy())
        return out

    monkeypatch.setattr(moe, "route", spy)
    logits = port.prefill(params, pb).float().numpy()
    monkeypatch.setattr(moe, "route", real)
    return logits, np.stack(routed)


@pytest.mark.parametrize("flash", [False, True])
def test_bf16_prefill_within_the_reference_bf16_distance(built, monkeypatch,
                                                         flash):
    ref16, rparams, port, params = built(ARCH, compute_dtype="bfloat16",
                                         use_flash_kernel=flash)
    ref32 = built(ARCH)[0]
    B, S = 2, 130
    rb, pb = batch(port.config, B, S)
    got, r_got = _port_routed(monkeypatch, port, params, pb)
    want, r_want = _ref_routed(monkeypatch, ref16, rparams, rb)
    f32, r_f32 = _ref_routed(monkeypatch, ref32, rparams, rb)
    same = ((r_got == r_want) & (r_want == r_f32)).all(axis=(0, 2))
    same = same.reshape(B, S)
    assert same.mean() >= 0.95
    assert_within_bf16_distance(got, want, f32, rows=same)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
def test_router_stays_float32(built, arch):
    """Under a bfloat16 param_dtype (kimi-k2's own) the router crosses over
    in float32, as the reference's init pins it; the rest in bfloat16."""
    _, rparams, _, params = built(arch, param_dtype="bfloat16")
    assert np.asarray(rparams["layers"]["moe"]["router"]).dtype == np.float32
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    assert params["layers"]["moe"]["we_up"].dtype == torch.bfloat16
    assert params["layers"]["attn"]["wq"].dtype == torch.bfloat16


def test_serve_loop_tokens_equal_reference(built):
    ref, rparams, port, params = built(ARCH)
    prompt = np.random.default_rng(0).integers(0, port.config.vocab, (4, 16))
    want = ref_serve_loop(ref, rparams, prompt, gen=8)
    res = serve.serve_loop(port, params,
                           torch.tensor(prompt, dtype=torch.int32), 8)
    np.testing.assert_array_equal(res["tokens"].numpy(), want)


def test_serve_cli_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--gen", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}: batch 4, prompt 16, generated 4" in out
    assert res["tokens"].shape == (4, 4)
    assert bool(torch.isfinite(res["logits"]).all())
