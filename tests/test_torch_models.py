"""The port's dense serving path against the JAX reference, on the CPU.

Reduced configs (2 layers, d_model 256, float32 compute) are built by
both packages; the reference's params cross over through
``repro_torch.convert.params_from_reference``, so both compute the same
function, and numpy-seeded tokens go through both:

  * ``prefill`` with the K5 branch off and on (on CPU tensors K5 is its
    plain version) against the reference's ``prefill``, rtol/atol 2e-4 --
    the bound of ``tests/test_online.py``'s flash-path test.  The
    reference's own flash branch never runs there (its layer windows are
    scan tracers); the port's is live, and the test counts its calls;
  * ``decode_step`` over 8 positions against the reference's (2e-4), and
    against the port's own prefill logits (2e-2, as
    ``tests/test_arch_smoke.py``), with the bf16/f32 cache and the int8
    cache;
  * the greedy tokens of ``repro_torch.launch.serve``'s loop against the
    reference serve loop's, equal;
  * in bf16 compute, ``prefill`` (K5 off and on) no farther from the
    reference's bf16 prefill than that is from its float32 prefill;
  * every config at its published width and depth, shapes only: the
    port's param tree, built on torch's ``meta`` device, has the leaf
    paths, shapes and dtypes of the reference's ``jax.eval_shape``.

The moe, hybrid and audio families have files of their own
(``tests/test_torch_{moe,hybrid,audio}.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.dist.steps import make_serve_step as ref_make_serve_step
from repro.models import build_model as ref_build_model
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve
from repro_torch.models import build_model, transformer
from repro_torch.models import layers as port_layers

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def built():
    """(ref model, ref params, port model, port params) per (arch, knobs),
    built once per module."""
    memo = {}

    def get(arch, **knobs):
        key = (arch, tuple(sorted(knobs.items())))
        if key not in memo:
            rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                       **knobs)
            cfg = dataclasses.replace(configs.get_config(arch).reduced(),
                                      **knobs)
            ref = ref_build_model(rcfg, max_seq=256)
            rparams = ref.init(jax.random.PRNGKey(0))
            tree = jax.tree.map(np.asarray, rparams)
            memo[key] = (ref, rparams, build_model(cfg, 256, device="cpu"),
                         params_from_reference(tree, cfg, "cpu"))
        return memo[key]

    return get


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    n_txt = S - cfg.n_patches if cfg.family == "vlm" else S
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, n_txt))}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    ref = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
           for k, v in batch.items()}
    port = {k: torch.tensor(v, dtype=torch.int32 if k == "tokens"
                            else torch.float32) for k, v in batch.items()}
    return ref, port


@pytest.fixture
def count_flash(monkeypatch):
    """Counts the model's calls of the K5 entry point."""
    calls = []
    real = port_layers.kops.flash_attention

    def counted(*args, **kw):
        calls.append(kw.get("window"))
        return real(*args, **kw)

    monkeypatch.setattr(port_layers.kops, "flash_attention", counted)
    return calls


def test_configs_equal_the_reference():
    assert sorted(configs.ARCHS) == sorted(REF_ARCHS)
    for name, cfg in configs.ARCHS.items():
        ref = dataclasses.asdict(REF_ARCHS[name])
        assert dataclasses.asdict(cfg) == ref
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(REF_ARCHS[name].reduced())
        assert cfg.param_count() == REF_ARCHS[name].param_count()


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_matches_reference(built, count_flash, flash):
    ref, rparams, port, params = built("llama3.2-1b", use_flash_kernel=flash)
    rb, pb = _batch(port.config, 2, 256)
    want = np.asarray(jax.jit(ref.prefill)(rparams, rb), np.float32)
    before = launch_counts()
    got = port.prefill(params, pb)
    assert launch_counts() == before         # CPU: plain versions only
    assert got.shape == (2, 256, port.config.vocab)
    assert len(count_flash) == (port.config.n_layers if flash else 0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("arch", ["gemma2-9b", "chatglm3-6b",
                                  "internvl2-1b"])
def test_prefill_other_dense_archs(built, count_flash, arch):
    """Sliding windows and softcaps (gemma2), half rope (chatglm3) and
    prepended patches (internvl2) through the K5 branch."""
    ref, rparams, port, params = built(arch, use_flash_kernel=True)
    rb, pb = _batch(port.config, 2, 128)
    want = np.asarray(jax.jit(ref.prefill)(rparams, rb), np.float32)
    got = port.prefill(params, pb)
    assert count_flash == transformer.layer_windows(port.config)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-9b", "chatglm3-6b",
                                  "internvl2-1b"])
def test_bf16_prefill_within_the_reference_bf16_distance(built, count_flash,
                                                         arch, flash):
    """bf16 compute, the full configs' default: the port's bf16 prefill is
    no farther from the reference's bf16 prefill than that is from the
    reference's own float32 prefill of the same params and tokens (the
    rounding of bf16 itself).  gemma2 brings the softcap and the sliding
    windows, chatglm3 the half rope, internvl2 the prepended patches; K5
    on is its plain version here."""
    ref16, rparams, port, params = built(arch, compute_dtype="bfloat16",
                                         use_flash_kernel=flash)
    ref32 = built(arch)[0]
    rb, pb = _batch(port.config, 2, 130)
    want = np.asarray(jax.jit(ref16.prefill)(rparams, rb), np.float32)
    f32 = np.asarray(jax.jit(ref32.prefill)(rparams, rb), np.float32)
    got = port.prefill(params, pb).float().numpy()
    assert len(count_flash) == (port.config.n_layers if flash else 0)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= np.abs(want - f32).max()


def test_loss_matches_reference(built):
    ref, rparams, port, params = built("llama3.2-1b")
    rb, pb = _batch(port.config, 2, 64)
    want, _ = jax.jit(ref.loss_fn)(rparams, rb)
    got, metrics = port.loss_fn(params, pb)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(metrics["loss"]) == float(got)


def _decode(ref, rparams, port, params, toks, slots):
    """Both decode paths over toks [B, n]; returns (ref, port) logits
    [B, n, V]."""
    B, n = toks.shape
    rcache, cache = ref.init_cache(B, slots), port.init_cache(B, slots)
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


@pytest.mark.parametrize("kv_cache_dtype", ["", "int8"])
def test_decode_matches_reference_and_prefill(built, kv_cache_dtype):
    ref, rparams, port, params = built("llama3.2-1b",
                                       kv_cache_dtype=kv_cache_dtype)
    toks = np.random.default_rng(2).integers(0, port.config.vocab, (2, 8))
    want, got = _decode(ref, rparams, port, params, toks, slots=16)
    np.testing.assert_allclose(got, want, **TOL)
    full = port.prefill(params, {"tokens": torch.tensor(toks)}).numpy()
    np.testing.assert_allclose(got, full, rtol=2e-2, atol=2e-2)


def test_rolling_cache_matches_reference(built):
    """A cache of 4 slots for 8 positions: writes wrap at pos % 4."""
    ref, rparams, port, params = built("gemma2-9b")
    toks = np.random.default_rng(3).integers(0, port.config.vocab, (2, 8))
    want, got = _decode(ref, rparams, port, params, toks, slots=4)
    np.testing.assert_allclose(got, want, **TOL)


def _ref_serve_loop(ref, rparams, prompt, gen):
    """The loop of ``repro.launch.serve.main``: the prompt stepped through
    the cache, then greedy decode."""
    B, P = prompt.shape
    step = jax.jit(ref_make_serve_step(ref))
    cache = ref.init_cache(B, P + gen)
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


def test_serve_loop_tokens_equal_reference(built):
    ref, rparams, port, params = built("llama3.2-1b")
    rng = np.random.default_rng(0)                 # the CLI's prompt seed
    prompt = rng.integers(0, port.config.vocab, (4, 16))
    want = _ref_serve_loop(ref, rparams, prompt, gen=32)
    res = serve.serve_loop(port, params,
                           torch.tensor(prompt, dtype=torch.int32), 32)
    assert res["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(res["tokens"].numpy(), want)
    assert res["logits"].shape == (4, port.config.vocab)


def test_serve_cli_on_cpu(capsys):
    res = serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                      "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] llama3.2-1b: batch 4, prompt 16, generated 4" in out
    assert "tok/s" in out and "sample tokens (seq 0)" in out
    assert res["tokens"].shape == (4, 4)


def _shape_tree(tree):
    """Leaf path -> (shape, dtype name), for torch and JAX leaves alike."""
    return {k: _shape_tree(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_full_width_param_tree_matches_reference(arch):
    """Every family at its published width and depth, shapes only: the
    port's init on torch's meta device (no storage, no draws) has the
    reference's leaf paths, shapes and dtypes from ``jax.eval_shape``."""
    ref = ref_build_model(REF_ARCHS[arch], max_seq=448)
    want = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    model = build_model(configs.get_config(arch), 448, device="meta")
    got = model.init(0)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(got))
    assert _shape_tree(got) == _shape_tree(want)


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(configs.get_config("llama3.2-1b").reduced())
