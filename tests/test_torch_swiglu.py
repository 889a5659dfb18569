"""The port's SwiGLU gate (K8 plain version) against the JAX reference.

The same NumPy inputs go through the port's ``swiglu`` and ``ops.swiglu``
(on CPU tensors: the plain PyTorch version) and through the reference's
Pallas kernel ``repro.kernels.swiglu.swiglu`` (interpret mode on the CPU,
as ``tests/test_kernels.py`` runs it), its ``repro.kernels.ops.swiglu``
and its oracle ``repro.kernels.ref.swiglu``.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 in float32, 2e-2 in bfloat16.
``tests/test_torch_gpu.py`` holds the CUDA kernel against the plain
version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.kernels.swiglu import swiglu as ref_kernel
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import swiglu as sg
from repro_torch.models import layers as port_layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, M, K, N, dtype="float32", scales=(0.1, 0.05, 0.05),
            lead=()):
    """x [*lead, M, K], w_gate and w_up [K, N] ~ N(0, 1) times ``scales``
    (those of ``tests/test_kernels.py``) as (jax, torch) triples."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrays = [(rng.standard_normal(shape) * sc).astype(np.float32)
              for shape, sc in zip((lead + (M, K), (K, N), (K, N)), scales)]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.tensor(a).to(tdt) for a in arrays])


def _close(port, *refs, dtype="float32"):
    got = port.float().numpy()
    for want in refs:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(128, 512, 128), (256, 1024, 512),
                                   (128, 256, 384)])
def test_matches_reference_kernel(M, K, N, dtype):
    (jx, jg, ju), (x, wg, wu) = _inputs(M + K + N, M, K, N, dtype)
    before = launch_counts()
    out = sg.swiglu(x, wg, wu)
    assert launch_counts() == before         # CPU tensors launch nothing
    assert out.dtype == x.dtype and out.shape == (M, N)
    _close(out, ref_kernel(jx, jg, ju, block_m=128, block_n=128,
                           block_k=min(512, K)),
           ref.swiglu(jx, jg, ju), dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,M,K,N", [((2,), 64, 256, 128),
                                        ((2, 3), 5, 64, 96),
                                        ((), 4, 256, 512)])
def test_ops_wrapper_any_leading_shape(lead, M, K, N, dtype):
    """[..., K] in, [..., N] out; 30 rows make the reference's ops halve
    its row block to 2, the port's kernel masks its edges instead."""
    (jx, jg, ju), (x, wg, wu) = _inputs(M + K, M, K, N, dtype, lead=lead)
    out = ops.swiglu(x, wg, wu)
    assert out.shape == lead + (M, N) and out.dtype == x.dtype
    oracle = ref.swiglu(jx.reshape(-1, K), jg, ju).reshape(lead + (M, N))
    _close(out, ref_ops.swiglu(jx, jg, ju), oracle, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_shape(dtype):
    """(100, 300, 200): no block of the reference divides it beyond 4, 4,
    8 (its ops would run ~47k interpret steps), so the port is held
    against the oracle."""
    (jx, jg, ju), (x, wg, wu) = _inputs(11, 100, 300, 200, dtype)
    _close(sg.swiglu(x, wg, wu), ref.swiglu(jx, jg, ju), dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extreme_gate(dtype):
    """|x @ w_gate| up to ~170: silu(g) = g / (1 + exp(-g)) is -0 for
    very negative g (exp overflows to inf); the reference's
    g * logistic(g) is a denormal there.  Finite and within tolerance.
    Small integers (u in 1/64ths) make every sum exact in fp32 in any
    order, so only silu and the product are compared."""
    rng = np.random.default_rng(12)
    arrays = [rng.integers(-2, 3, (64, 256)), rng.integers(-3, 4, (256, 128)),
              rng.integers(-3, 4, (256, 128)) / 64]
    jdt, tdt = DTYPES[dtype]
    jx, jg, ju = (jnp.asarray(a, jnp.float32).astype(jdt) for a in arrays)
    x, wg, wu = (torch.tensor(a, dtype=tdt) for a in arrays)
    g = x.float() @ wg.float()
    assert float(g.abs().max()) > 100.0 and float(g.min()) < -100.0
    out = sg.swiglu(x, wg, wu)
    assert bool(torch.isfinite(out).all())
    _close(out, ref_kernel(jx, jg, ju, block_m=64, block_n=128, block_k=256),
           ref.swiglu(jx, jg, ju), dtype=dtype)


def test_column_slice_weights_are_read_in_place():
    """A column slice of a wider weight has a contiguous last dim: the
    wrapper takes it as a view."""
    (jx, jg, ju), (x, wg, wu) = _inputs(13, 32, 64, 160)
    out = sg.swiglu(x, wg[:, 16:80], wu[:, 96:])
    _close(out, ref.swiglu(jx, jg[:, 16:80], ju[:, 96:]))


@pytest.mark.parametrize("bad, err, exc", [
    (dict(w_dtype=torch.bfloat16), "w_gate: dtype", TypeError),
    (dict(dtype=torch.float16), "dtype", TypeError),
    (dict(K_w=48), "do not fit", ValueError),
    (dict(N_up=40), "do not fit", ValueError),
    (dict(transpose_w=True), "w_gate: the last dim must be contiguous",
     ValueError),
    (dict(x_dim=3), "must be 2-D", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err, exc):
    dtype = bad.get("dtype", torch.float32)
    x = torch.zeros((8, 2, 64) if bad.get("x_dim") == 3 else (8, 64),
                    dtype=dtype)
    K_w = bad.get("K_w", 64)
    wg = torch.zeros((K_w, 32), dtype=bad.get("w_dtype", dtype))
    if bad.get("transpose_w"):
        wg = torch.zeros((32, 64), dtype=dtype).t()
    wu = torch.zeros((64, bad.get("N_up", 32)), dtype=dtype)
    with pytest.raises(exc, match=err):
        sg.swiglu(x, wg, wu)


@pytest.mark.parametrize("case, copied", [
    ("contiguous, width a multiple of 8", False),
    ("contiguous, odd width", True),
    ("one element off its allocation", True),
    ("column slice at a 16-byte offset", False),
    ("column slice at an odd offset", True),
])
def test_tma_operand_copies_only_what_tma_cannot_read(case, copied):
    """The bf16 kernel's TMA maps need a 16-byte-aligned base and rows a
    multiple of 8 elements apart: the wrapper hands such an operand over
    as it is and any other as a copy in a padded, aligned buffer, values
    unchanged."""
    base = torch.arange(64 * 200, dtype=torch.float32).reshape(64, 200) \
        .to(torch.bfloat16)
    t = {"contiguous, width a multiple of 8": base,
         "contiguous, odd width": base[:, :7].contiguous(),
         "one element off its allocation": base[:, 1:],
         "column slice at a 16-byte offset": base[:, 8:72],
         "column slice at an odd offset": base[:, 3:67]}[case]
    out = sg._tma_operand(t)
    assert torch.equal(out, t)
    assert (out.data_ptr() != t.data_ptr()) == copied
    assert out.data_ptr() % 16 == 0 and out.stride(0) % 8 == 0
    assert out.stride(0) >= out.shape[1] and out.stride(1) == 1


@pytest.fixture(scope="module")
def llama_mlp():
    """The reduced llama3.2-1b's MLP weights, from the reference's init
    carried over to the port (float32)."""
    rcfg = ref_get_config("llama3.2-1b").reduced()
    cfg = configs.get_config("llama3.2-1b").reduced()
    rparams = ref_build_model(rcfg, max_seq=64).init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg,
                                   "cpu")
    return cfg, rparams, params


@pytest.mark.parametrize("layer", [0, 1])
def test_equals_model_mlp_gate(llama_mlp, layer):
    """ops.swiglu equals the gate half of the models' in-line ``mlp`` (the
    port's and the reference's) on the reduced llama3.2-1b, float32,
    within 2e-5; through ``w_down`` it gives the whole ``mlp``."""
    cfg, rparams, params = llama_mlp
    assert cfg.mlp == "swiglu"
    rp = jax.tree.map(lambda a: a[layer], rparams["layers"]["mlp"])
    pp = {k: v[layer] for k, v in params["layers"]["mlp"].items()}
    rng = np.random.default_rng(layer)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    gate = ops.swiglu(tx, pp["w_gate"], pp["w_up"])
    assert gate.shape == (2, 16, cfg.d_ff)
    _close(gate, torch.nn.functional.silu(tx @ pp["w_gate"]) * (tx @ pp["w_up"]),
           jax.nn.silu(jx @ rp["w_gate"]) * (jx @ rp["w_up"]))
    _close(gate @ pp["w_down"], port_layers.mlp(pp, tx, "swiglu"),
           ref_layers.mlp(rp, jx, "swiglu"))
