"""The port's hybrid family (hymba-1.5b: attention and Mamba heads in
parallel) against the JAX reference, on the CPU.

Reduced configs (float32 compute; 2 layers, all global, and a 4-layer
variant whose second layer has a 32-token window) are built by both
packages; the reference's params cross over through
``params_from_reference`` and numpy-seeded inputs go through both, within
rtol/atol 2e-4:

  * ``associative_scan`` on random (a, b) against a sequential loop of the
    recurrence and against ``jax.lax.associative_scan`` (the same
    association order), at lengths that take every branch of the
    recursion;
  * ``mamba_seq`` and ``mamba_step`` alone (the stepped recurrence also
    against the parallel scan), in float32 and with bf16 activations
    against float32 weights (JAX's promotion);
  * ``prefill`` with the K5 branch off and on (K5 counted once per layer,
    with each layer's window), ``decode_step`` against the reference's and
    against the port's prefill, ``loss_fn``;
  * in bf16 compute, the prefill no farther from the reference's bf16
    prefill than that is from the reference's float32 one (mean distance,
    and largest distance up to one bf16 ulp: see
    ``_torch_families.assert_within_bf16_distance``);
  * ``dt_bias`` and ``A_log`` pinned to float32 under a bfloat16
    ``param_dtype``;
  * the serve loop's greedy tokens equal to the reference loop's, and the
    serve CLI on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (TOL, Built, assert_within_bf16_distance, batch,
                             bf16_prefills, count_flash, decode_both,
                             ref_serve_loop)
from repro.configs import get_config as ref_get_config
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.models import ssm, transformer

ARCH = "hymba-1.5b"


@pytest.fixture(scope="module")
def built():
    return Built()


@pytest.fixture
def flash_calls(monkeypatch):
    return count_flash(monkeypatch)


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("S", [1, 2, 3, 7, 8, 64, 100, 257])
def test_associative_scan_matches_loop_and_jax(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, S, 3, 4)).astype(np.float32)
    got_a, got_b = ssm.associative_scan(
        _combine, (torch.tensor(a), torch.tensor(b)), dim=1)
    h = np.zeros((2, 3, 4), np.float32)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(got_b[:, t].numpy(), h, rtol=2e-5,
                                   atol=2e-5)
    want_a, want_b = jax.lax.associative_scan(
        _combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6,
                               atol=1e-6)


def test_associative_scan_keeps_autograd():
    a = torch.rand(1, 9, 2, requires_grad=True)
    b = torch.randn(1, 9, 2, requires_grad=True)
    _, h = ssm.associative_scan(_combine, (a, b), dim=1)
    h.sum().backward()
    assert a.grad is not None and torch.isfinite(b.grad).all()


def _mamba_case(compute, seed=3, B=2, S=48):
    rcfg = ref_get_config(ARCH).reduced()
    cfg = configs.get_config(ARCH).reduced()
    rp = ref_ssm.init_mamba(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    pp = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    rx = jnp.asarray(x).astype(compute)
    px = torch.tensor(x).to(getattr(torch, compute))
    return rcfg, cfg, rp, pp, rx, px


@pytest.mark.parametrize("compute,tol", [("float32", 2e-4),
                                         ("bfloat16", 2e-2)])
def test_mamba_seq_matches_reference(compute, tol):
    """bf16 activations meet float32 weights: both packages compute the
    gates and the scan in float32 and the output in bf16."""
    rcfg, cfg, rp, pp, rx, px = _mamba_case(compute)
    want = jax.jit(lambda p, x: ref_ssm.mamba_seq(rcfg, p, x))(rp, rx)
    got = ssm.mamba_seq(cfg, pp, px)
    assert got.dtype == px.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mamba_step_matches_reference_and_the_scan(compute):
    rcfg, cfg, rp, pp, rx, px = _mamba_case(compute, S=12)
    B = px.shape[0]
    rstate = ref_ssm.init_mamba_state(rcfg, B, jnp.dtype(compute))
    state = ssm.init_mamba_state(cfg, B, px.dtype, "cpu")
    step = jax.jit(lambda p, s, x: ref_ssm.mamba_step(rcfg, p, s, x))
    got, want = [], []
    for t in range(px.shape[1]):
        y, rstate = step(rp, rstate, rx[:, t])
        o, state = ssm.mamba_step(cfg, pp, state, px[:, t])
        want.append(np.asarray(y, np.float32))
        got.append(o.float().numpy())
    tol = 2e-4 if compute == "float32" else 2e-2
    np.testing.assert_allclose(np.stack(got, 1), np.stack(want, 1), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(state["h"].numpy(), np.asarray(rstate["h"]),
                               rtol=tol, atol=tol)
    seq = ssm.mamba_seq(cfg, pp, px).float().numpy()
    np.testing.assert_allclose(np.stack(got, 1), seq, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n_layers", [2, 4])
@pytest.mark.parametrize("flash", [False, True])
def test_prefill_matches_reference(built, flash_calls, flash, n_layers):
    ref, rparams, port, params = built(ARCH, use_flash_kernel=flash,
                                       n_layers=n_layers)
    rb, pb = batch(port.config, 2, 128)
    want = np.asarray(jax.jit(ref.prefill)(rparams, rb), np.float32)
    got = port.prefill(params, pb)
    windows = transformer.layer_windows(port.config)
    assert (32 in windows) == (n_layers == 4)
    assert flash_calls == ([(True, w) for w in windows] if flash else [])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n_layers", [2, 4])
def test_decode_matches_reference_and_prefill(built, n_layers):
    ref, rparams, port, params = built(ARCH, n_layers=n_layers)
    toks = np.random.default_rng(2).integers(0, port.config.vocab, (2, 40))
    want, got = decode_both(ref, rparams, port, params, toks, slots=48)
    np.testing.assert_allclose(got, want, **TOL)
    full = port.prefill(params, {"tokens": torch.tensor(toks)}).numpy()
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
    assert_within_bf16_distance(*bf16_prefills(built, ARCH, flash, 2, 130,
                                               n_layers=4))


def test_mamba_gates_stay_float32(built):
    _, rparams, _, params = built(ARCH, param_dtype="bfloat16")
    m, rm = params["layers"]["mamba"], rparams["layers"]["mamba"]
    for name in ("dt_bias", "A_log"):
        assert np.asarray(rm[name]).dtype == np.float32
        assert m[name].dtype == torch.float32
    assert m["w_B"].dtype == torch.bfloat16


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
