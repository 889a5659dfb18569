"""The port's attention (K5 plain version) against the JAX reference.

The same NumPy inputs go through the port's ``flash_attention`` (on CPU
tensors: its plain PyTorch version) and through the reference's Pallas
kernel ``repro.kernels.flash_attention.flash_attention`` (interpret mode
on the CPU, as ``tests/test_kernels.py`` runs it) and its oracle
``repro.kernels.ref.flash_attention``.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 in float32, 2e-2 in bfloat16.
``tests/test_torch_gpu.py`` holds the CUDA kernel against the plain
version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as ref_kernel
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import launch_counts, ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, shapes, dtype="float32", scale=1.0):
    """The same float32 draws as (jax, torch) arrays cast to ``dtype``
    (both casts round to nearest even, so the bf16 values agree too)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrays = [rng.standard_normal(s).astype(np.float32) * scale
              for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.tensor(a).to(tdt) for a in arrays])


def _close(port, *refs, dtype="float32"):
    got = port.float().numpy()
    for want in refs:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,hd", [
    (1, 1, 128, 64), (2, 4, 256, 64), (1, 2, 512, 128), (2, 1, 128, 256),
])
def test_causal_matches_reference(B, H, S, hd, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(S + hd, [(B, H, S, hd)] * 3, dtype)
    before = launch_counts()
    out = fa.flash_attention(q, k, v, causal=True)
    assert launch_counts() == before         # CPU tensors launch nothing
    assert out.dtype == q.dtype
    _close(out, ref_kernel(jq, jk, jv, causal=True, block_q=128,
                           block_k=128),
           ref.flash_attention(jq, jk, jv, causal=True), dtype=dtype)


@pytest.mark.parametrize("window", [32, 128, 300])
def test_sliding_window(window):
    (jq, jk, jv), (q, k, v) = _inputs(1, [(1, 2, 256, 64)] * 3)
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    _close(out, ref_kernel(jq, jk, jv, causal=True, window=window,
                           block_q=64, block_k=64),
           ref.flash_attention(jq, jk, jv, causal=True, window=window))


def test_softcap():
    (jq, jk, jv), (q, k, v) = _inputs(2, [(1, 2, 128, 64)] * 3, scale=3.0)
    out = fa.flash_attention(q, k, v, causal=True, softcap=50.0)
    _close(out, ref_kernel(jq, jk, jv, causal=True, softcap=50.0,
                           block_q=64, block_k=64),
           ref.flash_attention(jq, jk, jv, causal=True, softcap=50.0))


def test_non_causal():
    (jq, jk, jv), (q, k, v) = _inputs(
        3, [(2, 2, 128, 64), (2, 2, 256, 64), (2, 2, 256, 64)])
    out = fa.flash_attention(q, k, v, causal=False)
    _close(out, ref_kernel(jq, jk, jv, causal=False, block_q=64, block_k=64),
           ref.flash_attention(jq, jk, jv, causal=False))


@pytest.mark.parametrize("causal", [False, True])
def test_kv_len_masks_padded_kv(causal):
    """kv_len = 200 of 256 kv rows: the reference kernel's padding mask."""
    (jq, jk, jv), (q, k, v) = _inputs(5, [(1, 2, 256, 64)] * 3)
    out = fa.flash_attention(q, k, v, causal=causal, kv_len=200)
    _close(out, ref_kernel(jq, jk, jv, causal=causal, kv_len=200,
                           block_q=64, block_k=64))


def test_ops_wrapper_gqa_and_ragged():
    """Model layout [B,S,H,hd], GQA and a sequence that is no block
    multiple (the reference wrapper repeats kv heads and pads; the port
    maps heads and masks)."""
    B, S, H, K, hd = 2, 200, 8, 2, 64
    (jq, jk, jv), (q, k, v) = _inputs(
        4, [(B, S, H, hd), (B, S, K, hd), (B, S, K, hd)])
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.shape == (B, S, H, hd)
    kk = jnp.repeat(jk, H // K, axis=2).transpose(0, 2, 1, 3)
    vv = jnp.repeat(jv, H // K, axis=2).transpose(0, 2, 1, 3)
    oracle = ref.flash_attention(jq.transpose(0, 2, 1, 3), kk, vv,
                                 causal=True).transpose(0, 2, 1, 3)
    _close(out, ref_ops.flash_attention(jq, jk, jv, causal=True), oracle)


def test_fully_masked_rows_give_zero():
    """kv_len = 0 masks every score: the kernel's max(l, 1e-30) guard
    returns 0 rather than the uniform average a plain softmax gives."""
    _, (q, k, v) = _inputs(6, [(1, 1, 64, 32)] * 3)
    out = fa.flash_attention(q, k, v, causal=False, kv_len=0)
    assert out.abs().max() > 0               # kv_len = 0 means "all"
    _, (q, k, v) = _inputs(6, [(1, 1, 64, 32), (1, 1, 8, 32), (1, 1, 8, 32)])
    out = fa.flash_attention_plain(q, k, v, causal=True, window=1,
                                   kv_len=4)
    assert torch.count_nonzero(out[0, 0, 4:]) == 0
    assert torch.all(out[0, 0, :4].abs().sum(-1) > 0)


@pytest.mark.parametrize("bad, err", [
    (dict(hd=48), "head dim"), (dict(K=3), "divide"),
    (dict(dtype=torch.float16), "dtype"), (dict(transpose=True), "contig"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    hd, K = bad.get("hd", 64), bad.get("K", 2)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros((1, 4, 16, hd), dtype=dtype)
    k = torch.zeros((1, K, 16, hd), dtype=dtype)
    if bad.get("transpose"):
        q = torch.zeros((1, 4, hd, 16)).transpose(2, 3)
    with pytest.raises((TypeError, ValueError), match=err):
        fa.flash_attention(q, k, k)
