"""The port's RMSNorm (K7 plain version) against the JAX reference.

The same NumPy inputs go through the port's ``rmsnorm`` and
``ops.rmsnorm`` (on CPU tensors: the plain PyTorch version) and through
the reference's Pallas kernel ``repro.kernels.rmsnorm.rmsnorm`` (interpret
mode on the CPU, as ``tests/test_kernels.py`` runs it), its
``repro.kernels.ops.rmsnorm`` and its oracle ``repro.kernels.ref.rmsnorm``.
Tolerances are those of ``tests/test_kernels.py``: 2e-5 in float32, 2e-2
in bfloat16.  ``tests/test_torch_gpu.py`` holds the CUDA kernel against
the plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.kernels.rmsnorm import rmsnorm as ref_kernel
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import layers as port_layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, x_shape, dtype="float32"):
    """x ~ N(0, 1) and scale ~ N(1, 1) as (jax, torch) pairs in ``dtype``
    (both casts round to nearest even, so the bf16 values agree)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal(x_shape).astype(np.float32)
    s = (rng.standard_normal(x_shape[-1]) + 1.0).astype(np.float32)
    return ((jnp.asarray(x).astype(jdt), jnp.asarray(s).astype(jdt)),
            (torch.tensor(x).to(tdt), torch.tensor(s).to(tdt)))


def _close(port, *refs, dtype="float32"):
    got = port.float().numpy()
    for want in refs:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(8, 128), (256, 512), (1024, 4096),
                                    (64, 3584)])
def test_matches_reference_kernel(rows, d, dtype):
    (jx, js), (x, s) = _inputs(rows + d, (rows, d), dtype)
    before = launch_counts()
    out = rn.rmsnorm(x, s)
    assert launch_counts() == before         # CPU tensors launch nothing
    assert out.dtype == x.dtype and out.shape == (rows, d)
    _close(out, ref_kernel(jx, js, block_rows=min(256, rows)),
           ref.rmsnorm(jx, js), dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 64, 128), (100, 3000), (5, 7, 96),
                                   (256,)])
def test_ops_wrapper_any_leading_shape(shape, dtype):
    """The reference's ops halves its row block until it divides the row
    count (100 rows: blocks of 4, 35 rows: 1); the port's kernel needs no
    such rule."""
    (jx, js), (x, s) = _inputs(sum(shape), shape, dtype)
    out = ops.rmsnorm(x, s)
    assert out.shape == x.shape and out.dtype == x.dtype
    oracle = ref.rmsnorm(jx.reshape(-1, shape[-1]), js).reshape(shape)
    _close(out, ref_ops.rmsnorm(jx, js), oracle, dtype=dtype)


@pytest.mark.parametrize("eps", [1e-6, 1e-5, 0.5])
def test_eps(eps):
    (jx, js), (x, s) = _inputs(3, (16, 64))
    _close(rn.rmsnorm(x * 1e-3, s, eps=eps),
           ref_kernel(jx * 1e-3, js, eps=eps), ref.rmsnorm(jx * 1e-3, js,
                                                           eps=eps))


def test_scale_dtype_is_cast_once():
    """A bf16 x with a float32 scale: the scale enters in float32."""
    (jx, js), (x, s) = _inputs(4, (32, 256), "bfloat16")
    _close(rn.rmsnorm(x, s.float()), ref.rmsnorm(jx, js.astype(jnp.float32)),
           dtype="bfloat16")


def test_ops_wrapper_reads_strided_rows():
    """A row-strided view goes to the kernel wrapper as it is (its
    feature dim is contiguous); the result equals that of a copy."""
    _, (wide, s) = _inputs(6, (4, 10, 80))
    x = wide[..., 8:72]
    assert x.reshape(-1, 64).data_ptr() == x.data_ptr()
    _close(ops.rmsnorm(x, s[8:72]), ops.rmsnorm(x.contiguous(), s[8:72]))


@pytest.mark.parametrize("bad, err, exc", [
    (dict(dtype=torch.float16), "dtype", TypeError),
    (dict(scale_shape=(63,)), "shape", ValueError),
    (dict(scale_dtype=torch.int32), "scale: dtype", TypeError),
    (dict(x_shape=(2, 3, 64)), r"\[rows, d\]", ValueError),
    (dict(transpose=True), "contiguous", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err, exc):
    x = torch.zeros(bad.get("x_shape", (8, 64)),
                    dtype=bad.get("dtype", torch.float32))
    if bad.get("transpose"):
        x = torch.zeros((64, 8)).t()
    s = torch.ones(bad.get("scale_shape", (64,)),
                   dtype=bad.get("scale_dtype", torch.float32))
    with pytest.raises(exc, match=err):
        rn.rmsnorm(x, s)


@pytest.fixture(scope="module")
def llama_norms():
    """The reduced llama3.2-1b's norm scales (ln1, ln2 of each layer and
    ln_f), from the reference's init carried over to the port."""
    rcfg = ref_get_config("llama3.2-1b").reduced()
    cfg = configs.get_config("llama3.2-1b").reduced()
    rparams = ref_build_model(rcfg, max_seq=64).init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg,
                                   "cpu")
    # Scales are ones at init: perturb them (the same numbers for both) so
    # the product with the scale is exercised.
    rng = np.random.default_rng(0)
    scales = [np.asarray(params["layers"][ln][i]) + rng.standard_normal(
        cfg.d_model).astype(np.float32) * 0.1
        for ln in ("ln1", "ln2") for i in range(cfg.n_layers)]
    scales.append(np.asarray(params["ln_f"]))
    return cfg, scales


def test_equals_model_rms_norm(llama_norms):
    """ops.rmsnorm equals the models' in-line ``rms_norm`` (the port's and
    the reference's) on the reduced llama3.2-1b, float32, within 2e-5."""
    cfg, scales = llama_norms
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 16, cfg.d_model)) * 3.0).astype(np.float32)
    tx = torch.tensor(x)
    for s in scales:
        out = ops.rmsnorm(tx, torch.tensor(s), cfg.norm_eps)
        _close(out, port_layers.rms_norm(tx, torch.tensor(s), cfg.norm_eps),
               ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(s),
                                   cfg.norm_eps))
    assert cfg.norm_cast_early is False      # the model's norm is K7's math
